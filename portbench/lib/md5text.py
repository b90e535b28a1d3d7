"""`md5(v::text)` of many whole numbers at once, as dictionary-encoded
text: MD5 (RFC 1321) of each number's decimal digits, in NumPy over
blocks of rows in threads, and a sorted dictionary of the hex digests.

A message of at most 55 bytes fits MD5's one 64-byte block: the digits,
the byte 0x80, zeros, and the bit length in the block's last 8 bytes.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np

from portbench.lib.dataset import Col

_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + \
    [6, 10, 15, 21] * 4
_K = [int(abs(np.sin(i + 1)) * 2**32) & 0xFFFFFFFF for i in range(64)]
_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)
# two ASCII hex digits of each byte, as one little-endian uint16
_HEX = np.array([int.from_bytes(f"{i:02x}".encode(), "little")
                 for i in range(256)], dtype=np.uint16)
_BLOCK = 1 << 18


def _block_words(v: np.ndarray) -> list:
    """The 16 words of each number's one MD5 block, as uint32 arrays;
    None for a word that is 0 in every row (at most 15 digits)."""
    v = v.astype(np.int64)
    if len(v) and (v.min() < 0 or v.max() >= 10 ** 15):
        raise ValueError("md5 text takes whole numbers in [0, 10^15)")
    digits = np.ones(len(v), dtype=np.int64)
    while (v >= 10 ** digits).any():
        digits += v >= 10 ** digits
    msg = np.zeros((len(v), 16), dtype=np.uint8)
    for j in range(int(digits.max(initial=1)) + 1):
        p = 10 ** np.maximum(digits - 1 - j, 0)
        msg[:, j] = np.where(j < digits, 48 + (v // p) % 10,
                             np.where(j == digits, 0x80, 0))
    w = msg.view("<u4")
    m = [np.ascontiguousarray(w[:, i]) for i in range(4)] + [None] * 12
    m[14] = (digits * 8).astype(np.uint32)
    return m


def _digest(m: list, n: int) -> np.ndarray:
    """(n, 16) uint8: the MD5 digest of each row's one block, in place
    over five registers' arrays."""
    a, b, c, d = (np.full(n, x, dtype=np.uint32) for x in _INIT)
    f, t = np.empty(n, np.uint32), np.empty(n, np.uint32)
    for i in range(64):
        if i < 16:
            g = i
            np.bitwise_and(b, c, out=f)
            np.invert(b, out=t)
            np.bitwise_and(t, d, out=t)
            np.bitwise_or(f, t, out=f)
        elif i < 32:
            g = (5 * i + 1) % 16
            np.bitwise_and(d, b, out=f)
            np.invert(d, out=t)
            np.bitwise_and(t, c, out=t)
            np.bitwise_or(f, t, out=f)
        elif i < 48:
            g = (3 * i + 5) % 16
            np.bitwise_xor(b, c, out=f)
            np.bitwise_xor(f, d, out=f)
        else:
            g = (7 * i) % 16
            np.invert(d, out=t)
            np.bitwise_or(t, b, out=t)
            np.bitwise_xor(c, t, out=f)
        np.add(f, a, out=f)
        np.add(f, np.uint32(_K[i]), out=f)
        if m[g] is not None:
            np.add(f, m[g], out=f)
        np.left_shift(f, np.uint32(_S[i]), out=t)
        np.right_shift(f, np.uint32(32 - _S[i]), out=f)
        np.bitwise_or(f, t, out=f)
        np.add(f, b, out=f)
        # a <- d, d <- c, c <- b, b <- the sum; a's array is free again
        a, d, c, b, f = d, c, b, f, a
    out = np.stack([a + np.uint32(_INIT[0]), b + np.uint32(_INIT[1]),
                    c + np.uint32(_INIT[2]), d + np.uint32(_INIT[3])],
                   axis=1).astype("<u4")
    return out.view(np.uint8)


def md5_digests(values: np.ndarray, workers: int = 8) -> np.ndarray:
    """(n, 16) uint8 digests of `md5(v::text)` for each v."""
    out = np.empty((len(values), 16), dtype=np.uint8)

    def one(a: int) -> None:
        z = min(a + _BLOCK, len(values))
        out[a:z] = _digest(_block_words(values[a:z]), z - a)

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for f in [ex.submit(one, a) for a in range(0, len(values), _BLOCK)]:
            f.result()
    return out


def md5_text_col(values: np.ndarray, workers: int = 8) -> Col:
    """A text column whose row i is md5(values[i]::text), the values
    distinct: the dictionary is the sorted digests, the codes their
    ranks.  Hex order is digest byte order, so the rows sort by their
    digests' first 8 bytes, and by all 16 should two of those tie."""
    dig = md5_digests(values, workers)
    hi = dig[:, :8].copy().view(">u8").ravel()
    order = np.argsort(hi)
    sh = hi[order]
    if (sh[1:] == sh[:-1]).any():
        lo = dig[:, 8:].copy().view(">u8").ravel()
        order = np.lexsort((lo, hi))
    codes = np.empty(len(values), dtype=np.int32)
    codes[order] = np.arange(len(values), dtype=np.int32)
    # 32 hex digits and a separator "\n\n" a row, split in one call
    lines = np.full((len(values), 17), 0x0A0A, dtype=np.uint16)
    lines[:, :16] = _HEX[dig[order]]
    dictionary = lines.tobytes().decode("ascii").split("\n\n")[:-1]
    return Col("text", codes, dictionary)
