"""Bit-exact regeneration of the reference's PostgreSQL regression fixture.

The reference generates gpupreagg_test / gpupreagg_overflow_test with
`SELECT setseed(0)` + `random()` (input/sql/agg_init.sql).  PostgreSQL <=9.x
random() is glibc random(); our native PgRandom reproduces that generator
bit-for-bit, and this module replays the INSERT ... SELECT expressions with
PostgreSQL's exact evaluation order and cast semantics:

  * targetlist expressions evaluate left-to-right per row;
  * `case when random() > 0.95 then null else <expr> end` draws once for the
    condition and once more inside <expr> only when the condition is false;
  * float8 -> int casts are rint() (half-to-even) + range check;
  * float8 -> numeric goes through "%.15g" text (DBL_DIG), numeric round()
    is half-away-from-zero at the given scale;
  * numeric -> float4/float8 casts parse the numeric's text form.

Because the PRNG stream is exact, aggregate results over this table can be
diffed directly against the reference's expected/*.out goldens.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from ..sqltypes import T
from ..datastore import Table, column_from_values
from ..native import PgRandom
from .. import pgnumeric as pgn

INT2_MAX = 32767
INT4_MAX = 2147483647
INT8_MAX = 9223372036854775807


def _pg_float8_to_numeric(v: float) -> Decimal:
    """PG float8_numeric: snprintf("%.15g") then numeric_in."""
    return Decimal("%.15g" % v)


def _dtoi(v: float, lo: int, hi: int) -> int:
    r = int(np.rint(np.float64(v)))
    if r < lo or r > hi:
        raise OverflowError(f"{v} out of range [{lo},{hi}]")
    return r


def _numeric_to_float4(d: Decimal) -> float:
    # PG numeric -> float4 parses the numeric text; float(str) -> f64 is the
    # correctly-rounded double, then np.float32 rounds to single.  (A direct
    # strtof differs only in double-rounding corner cases.)
    return float(np.float32(float(d)))


def _numeric_to_float8(d: Decimal) -> float:
    return float(d)


class _Gen:
    def __init__(self) -> None:
        self.r = PgRandom()
        self.r.setseed(0.0)

    def draw(self) -> float:
        return self.r.drandom()

    def maybe(self, fn):
        """case when random() > 0.95 then null else fn(random()) end"""
        if self.draw() > 0.95:
            return None
        return fn(self.draw())


def regen_preagg_test(name: str = "gpupreagg_test") -> Table:
    g = _Gen()
    cols: dict[str, list] = {k: [] for k in
                             ("id", "key", "smlint_x", "integer_x", "bigint_x",
                              "real_x", "float_x", "nume_x",
                              "smlsrl_x", "serial_x", "bigsrl_x")}

    def rows(section: int) -> None:
        for i in range(10001):
            # PostgreSQL SRF-in-targetlist executors evaluate the whole
            # targetlist one extra time after the series is exhausted and
            # discard the row — random() draws ARE consumed (this is load-
            # bearing for PRNG-stream parity with expected/*.out)
            discard = (i == 10000)
            rid = section * 10000 + i + 1
            if not discard:
                cols["id"].append(rid)
            if section == 3:
                if discard:
                    continue
                cols["key"].append(None)
                for c in ("smlint_x", "integer_x", "bigint_x", "real_x",
                          "float_x", "nume_x"):
                    cols[c].append(None)
                for c in ("smlsrl_x", "serial_x", "bigsrl_x"):
                    cols[c].append(0)
                continue
            if not discard:
                cols["key"].append(section * 10 + (i % 10) + 1)
            if section == 0:
                sgn = lambda r: r            # random()
                sgn1 = lambda r: r
            elif section == 1:
                sgn = lambda r: -r           # random()*-C
                sgn1 = lambda r: r * -1      # (random()*-1)
            else:
                sgn = lambda r: r * 2 - 1    # (random()*2-1)
                sgn1 = lambda r: r * 2 - 1
            # smlint_x / integer_x / bigint_x: s(r)*C/1000 -> int cast
            vals = {}
            vals["smlint_x"] = g.maybe(
                lambda r: _dtoi(sgn(r) * INT2_MAX / 1000, -32768, 32767))
            vals["integer_x"] = g.maybe(
                lambda r: _dtoi(sgn(r) * INT4_MAX / 1000,
                                -(1 << 31), (1 << 31) - 1))
            vals["bigint_x"] = g.maybe(
                lambda r: _dtoi(sgn(r) * INT8_MAX / 1000,
                                -(1 << 63), (1 << 63) - 1))
            # real_x: round(s1(r)::numeric, 4)::real
            vals["real_x"] = g.maybe(
                lambda r: _numeric_to_float4(
                    pgn.round_to_scale(_pg_float8_to_numeric(sgn1(r)), 4)))
            # float_x: round(s1(r)::numeric, 13)::float8
            vals["float_x"] = g.maybe(
                lambda r: _numeric_to_float8(
                    pgn.round_to_scale(_pg_float8_to_numeric(sgn1(r)), 13)))
            # nume_x: s1(r)::numeric
            vals["nume_x"] = g.maybe(
                lambda r: _pg_float8_to_numeric(sgn1(r)))
            # serial columns: no NULL case, one draw each
            vals["smlsrl_x"] = _dtoi(sgn(g.draw()) * INT2_MAX / 1000,
                                     -32768, 32767)
            vals["serial_x"] = _dtoi(sgn(g.draw()) * INT4_MAX / 1000,
                                     -(1 << 31), (1 << 31) - 1)
            vals["bigsrl_x"] = _dtoi(sgn(g.draw()) * INT8_MAX / 1000,
                                     -(1 << 63), (1 << 63) - 1)
            if not discard:
                for c, v in vals.items():
                    cols[c].append(v)

    for sec in range(4):
        rows(sec)

    return Table.from_columns(name, {
        "id": column_from_values(T.INT4, cols["id"]),
        "key": column_from_values(T.INT4, cols["key"]),
        "smlint_x": column_from_values(T.INT2, cols["smlint_x"]),
        "integer_x": column_from_values(T.INT4, cols["integer_x"]),
        "bigint_x": column_from_values(T.INT8, cols["bigint_x"]),
        "real_x": column_from_values(T.FLOAT4, cols["real_x"]),
        "float_x": column_from_values(T.FLOAT8, cols["float_x"]),
        "nume_x": column_from_values(T.NUMERIC, cols["nume_x"]),
        "smlsrl_x": column_from_values(T.INT2, cols["smlsrl_x"]),
        "serial_x": column_from_values(T.INT4, cols["serial_x"]),
        "bigsrl_x": column_from_values(T.INT8, cols["bigsrl_x"]),
    })


def regen_preagg_overflow(name: str = "gpupreagg_overflow_test") -> Table:
    g = _Gen()
    cols: dict[str, list] = {k: [] for k in
                             ("id", "key", "smlint_x", "integer_x", "bigint_x",
                              "real_x", "float_x", "nume_x",
                              "smlsrl_x", "serial_x", "bigsrl_x")}

    def rows(section: int) -> None:
        for i in range(10001):
            # PostgreSQL SRF-in-targetlist executors evaluate the whole
            # targetlist one extra time after the series is exhausted and
            # discard the row — random() draws ARE consumed (this is load-
            # bearing for PRNG-stream parity with expected/*.out)
            discard = (i == 10000)
            rid = section * 10000 + i + 1
            if not discard:
                cols["id"].append(rid)
            if section == 3:
                if discard:
                    continue
                cols["key"].append(None)
                for c in ("smlint_x", "integer_x", "bigint_x", "real_x",
                          "float_x", "nume_x"):
                    cols[c].append(None)
                for c in ("smlsrl_x", "serial_x", "bigsrl_x"):
                    cols[c].append(0)
                continue
            if not discard:
                cols["key"].append(section * 10 + (i % 10) + 1)
            if section == 0:
                pick = lambda pos, neg: pos
                fmul = 1.0
                serial_sign = lambda r: r
            elif section == 1:
                pick = lambda pos, neg: neg
                fmul = -1.0
                serial_sign = lambda r: -r
            else:
                pick = None
                serial_sign = lambda r: r * 2 - 1

            vals = {}
            if section in (0, 1):
                vals["smlint_x"] = (None if g.draw() > 0.95
                                    else (32767 if section == 0 else -32768))
                vals["integer_x"] = (None if g.draw() > 0.95
                                     else (INT4_MAX if section == 0 else -INT4_MAX - 1))
                vals["bigint_x"] = (None if g.draw() > 0.95
                                    else (INT8_MAX if section == 0 else -INT8_MAX - 1))
                vals["real_x"] = (None if g.draw() > 0.95
                                  else float(np.float32(fmul * 1.0e38)))
                vals["float_x"] = (None if g.draw() > 0.95
                                   else fmul * 1.0e308)
                # floor(random()*1e21) [* -1 in section 1]
                vals["nume_x"] = g.maybe(
                    lambda r: _floor_numeric(r * 1e21) * (1 if section == 0 else -1))
            else:
                # (random()*2-1)*C with float8 -> int cast
                vals["smlint_x"] = g.maybe(
                    lambda r: _dtoi((r * 2 - 1) * 32767, -32768, 32767))
                vals["integer_x"] = g.maybe(
                    lambda r: _dtoi((r * 2 - 1) * INT4_MAX,
                                    -(1 << 31), (1 << 31) - 1))
                vals["bigint_x"] = g.maybe(
                    lambda r: _dtoi_clamp_i8((r * 2 - 1) * INT8_MAX))
                vals["real_x"] = g.maybe(
                    lambda r: float(np.float32((r * 2 - 1) * 1.0e38)))
                vals["float_x"] = g.maybe(
                    lambda r: (r * 2 - 1) * 1.0e308)
                vals["nume_x"] = g.maybe(
                    lambda r: _floor_numeric((r * 2 - 1) * 1e21))
            vals["smlsrl_x"] = _dtoi(serial_sign(g.draw()) * 32767,
                                     -32768, 32767)
            vals["serial_x"] = _dtoi(serial_sign(g.draw()) * INT4_MAX,
                                     -(1 << 31), (1 << 31) - 1)
            vals["bigsrl_x"] = _dtoi_clamp_i8(serial_sign(g.draw()) * INT8_MAX)
            if not discard:
                for c, v in vals.items():
                    cols[c].append(v)

    for sec in range(4):
        rows(sec)

    return Table.from_columns(name, {
        "id": column_from_values(T.INT4, cols["id"]),
        "key": column_from_values(T.INT4, cols["key"]),
        "smlint_x": column_from_values(T.INT2, cols["smlint_x"]),
        "integer_x": column_from_values(T.INT4, cols["integer_x"]),
        "bigint_x": column_from_values(T.INT8, cols["bigint_x"]),
        "real_x": column_from_values(T.FLOAT4, cols["real_x"]),
        "float_x": column_from_values(T.FLOAT8, cols["float_x"]),
        "nume_x": column_from_values(T.NUMERIC, cols["nume_x"]),
        "smlsrl_x": column_from_values(T.INT2, cols["smlsrl_x"]),
        "serial_x": column_from_values(T.INT4, cols["serial_x"]),
        "bigsrl_x": column_from_values(T.INT8, cols["bigsrl_x"]),
    })


def _floor_numeric(v: float) -> Decimal:
    """floor(float8) stays float8 in PG; ::numeric via %.15g text."""
    import math
    return _pg_float8_to_numeric(math.floor(v))


def _dtoi_clamp_i8(v: float) -> int:
    """float8 -> int8: values like rint(9.22e18) land exactly at 2^63 and
    PG raises; the fixture relies on * (value/1000 etc.) staying in range.
    Keep the error surface for honesty."""
    r = int(np.rint(np.float64(v)))
    if r < -(1 << 63) or r > (1 << 63) - 1:
        # PG dtoi8 rejects out-of-range; 9223372036854775807 as float8 is
        # exactly 2^63 which IS out of range for int8... but PG's check is
        # val < -9.22e18 || val > 9.22e18 on the float -> passes, then the
        # (int64) conversion of 2^63 wraps to INT64_MIN?? PG 9.x dtoi8:
        #   if (val < (double) PG_INT64_MIN || val > (double) PG_INT64_MAX)
        # (double)PG_INT64_MAX == 2^63, so val == 2^63 passes the check and
        # the cast is implementation-defined; on x86-64 it saturates to
        # INT64_MIN via cvttsd2si...  glibc-era PG accepted it; reproduce
        # the x86-64 behavior:
        return -(1 << 63)
    return r


def regen_preagg_mix(db) -> Table:
    """The gpupreagg_mix materialized view (agg_init.sql): 3-way self-join
    of the three random sections aligned by id, built with the engine."""
    from ..sql import execute
    sql = """
    select x.id as id, x.key as key,
      x.smlint_x as smlint_x, y.smlint_x as smlint_y, z.smlint_x as smlint_z,
      x.integer_x as integer_x, y.integer_x as integer_y, z.integer_x as integer_z,
      x.bigint_x as bigint_x, y.bigint_x as bigint_y, z.bigint_x as bigint_z,
      x.real_x as real_x, y.real_x as real_y, z.real_x as real_z,
      x.float_x as float_x, y.float_x as float_y, z.float_x as float_z,
      x.nume_x as nume_x, y.nume_x as nume_y, z.nume_x as nume_z,
      x.smlsrl_x as smlsrl_x, y.smlsrl_x as smlsrl_y, z.smlsrl_x as smlsrl_z,
      x.serial_x as serial_x, y.serial_x as serial_y, z.serial_x as serial_z,
      x.bigsrl_x as bigsrl_x, y.bigsrl_x as bigsrl_y, z.bigsrl_x as bigsrl_z
    from (select * from gpupreagg_test where id <= 10000) as x,
         (select id - 10000 as id, key - 10 as key, smlint_x, integer_x,
                 bigint_x, real_x, float_x, nume_x, smlsrl_x, serial_x,
                 bigsrl_x from gpupreagg_test where key between 11 and 20) as y,
         (select id - 20000 as id, key - 20 as key, smlint_x, integer_x,
                 bigint_x, real_x, float_x, nume_x, smlsrl_x, serial_x,
                 bigsrl_x from gpupreagg_test where key between 21 and 30) as z
    where x.id = y.id and y.id = z.id and z.id = x.id
    """
    r = execute(sql, db)
    cols = {}
    for i, (nm, t) in enumerate(zip(r.columns, r.types)):
        cols[nm] = column_from_values(t, [row[i] for row in r.rows])
    return Table.from_columns("gpupreagg_mix", cols)
