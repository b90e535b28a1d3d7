"""The Star Schema Benchmark (O'Neil, O'Neil, Chen; Revision 3, 2009),
generated from a seed with NumPy in place of dbgen.

Every table keeps every column of the specification.  Keys are uniform
as in dbgen; an order holds 1-7 lines that share its customer, date and
priority; prices follow dbgen's formulas (in cents).  The sizes come from
the configuration: lineorder = 6,000,000 x SF rows, customer 30,000 x SF,
supplier 2,000 x SF, part 200,000 x floor(1 + log2 SF), date 2,556 days
from 1992-01-01.  Text is dictionary-encoded.  What dbgen does otherwise
and this generator does not is listed under `assumed` in the
configuration file.
"""

from __future__ import annotations

import datetime

import numpy as np

from portbench.lib.dataset import (Col, Dataset, parallel_fill, rng_of,
                                   text_col, unique_text_col)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
TYPES = [f"{a} {b} {c}"
         for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
# sorted, so that a row's draw is its code in the column's dictionary
SHIPMODES = sorted(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                    "FOB"])
MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]
DAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday",
        "Sunday"]
CITIES = [f"{name[:9]:<9}{d}" for name, _ in NATIONS for d in range(10)]


def _alnum(rng: np.random.Generator, n: int, width: int) -> np.ndarray:
    """n random strings of `width` letters and digits, as bytes."""
    alphabet = np.frombuffer(
        b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789",
        dtype=np.uint8)
    m = alphabet[rng.integers(0, len(alphabet), (n, width))]
    return m.view(f"S{width}").ravel()


def _phones(rng: np.random.Generator, nation: np.ndarray) -> np.ndarray:
    """'CC-DDD-DDD-DDDD' with CC = nation + 10, as bytes."""
    n = len(nation)
    m = (rng.integers(0, 10, (n, 15)) + ord("0")).astype(np.uint8)
    m[:, 0] = ord("0") + (nation + 10) // 10
    m[:, 1] = ord("0") + (nation + 10) % 10
    m[:, [2, 6, 10]] = ord("-")
    m[:, 3] = ord("1") + m[:, 3] % 9
    return m.view("S15").ravel()


def _place(rng: np.random.Generator, n: int) -> dict[str, Col]:
    """City, nation and region of n customers or suppliers."""
    nation = rng.integers(0, 25, n)
    city = nation * 10 + rng.integers(0, 10, n)
    region = np.array([r for _, r in NATIONS])[nation]
    return {"city": text_col(CITIES, city),
            "nation": text_col([nm for nm, _ in NATIONS], nation),
            "region": text_col(REGIONS, region),
            "_nation": nation}


def _numbered(prefix: str, n: int) -> Col:
    return Col("text", np.arange(n, dtype=np.int32),
               [f"{prefix}#{i:09d}" for i in range(1, n + 1)])


def _customer(rng, n):
    p = _place(rng, n)
    return {"c_custkey": Col("int4", np.arange(1, n + 1, dtype=np.int32)),
            "c_name": _numbered("Customer", n),
            "c_address": unique_text_col(_alnum(rng, n, 15)),
            "c_city": p["city"], "c_nation": p["nation"],
            "c_region": p["region"],
            "c_phone": unique_text_col(_phones(rng, p["_nation"])),
            "c_mktsegment": text_col(SEGMENTS, rng.integers(0, 5, n))}


def _supplier(rng, n):
    p = _place(rng, n)
    return {"s_suppkey": Col("int4", np.arange(1, n + 1, dtype=np.int32)),
            "s_name": _numbered("Supplier", n),
            "s_address": unique_text_col(_alnum(rng, n, 15)),
            "s_city": p["city"], "s_nation": p["nation"],
            "s_region": p["region"],
            "s_phone": unique_text_col(_phones(rng, p["_nation"]))}


def retail_price(partkey: np.ndarray) -> np.ndarray:
    """dbgen's retail price of a part, in cents."""
    pk = partkey.astype(np.int64)
    return (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)).astype(np.int32)


def _part(rng, n):
    mfgr = rng.integers(0, 5, n)
    cat = rng.integers(0, 5, n)
    brand = rng.integers(0, 40, n)
    c1 = rng.integers(0, len(COLORS), n)
    c2 = (c1 + rng.integers(1, len(COLORS), n)) % len(COLORS)
    names = [f"{a} {b}" for a in COLORS for b in COLORS]
    return {
        "p_partkey": Col("int4", np.arange(1, n + 1, dtype=np.int32)),
        "p_name": text_col(names, c1 * len(COLORS) + c2),
        "p_mfgr": text_col([f"MFGR#{m}" for m in range(1, 6)], mfgr),
        "p_category": text_col([f"MFGR#{m}{c}" for m in range(1, 6)
                                for c in range(1, 6)], mfgr * 5 + cat),
        "p_brand1": text_col([f"MFGR#{m}{c}{b}" for m in range(1, 6)
                              for c in range(1, 6) for b in range(1, 41)],
                             mfgr * 200 + cat * 40 + brand),
        "p_color": text_col(COLORS, rng.integers(0, len(COLORS), n)),
        "p_type": text_col(TYPES, rng.integers(0, len(TYPES), n)),
        "p_size": Col("int4", rng.integers(1, 51, n).astype(np.int32)),
        "p_container": text_col(CONTAINERS,
                                rng.integers(0, len(CONTAINERS), n)),
    }


def _date(days: int) -> tuple[dict[str, Col], np.ndarray]:
    d0 = datetime.date(1992, 1, 1)
    ds = [d0 + datetime.timedelta(i) for i in range(days)]
    i32 = lambda v: Col("int4", np.asarray(v, dtype=np.int32))  # noqa: E731
    key = np.array([d.year * 10000 + d.month * 100 + d.day for d in ds],
                   dtype=np.int32)
    doy = [d.timetuple().tm_yday for d in ds]
    season = {12: "Christmas", 1: "Winter", 2: "Winter", 6: "Summer",
              7: "Summer", 8: "Summer", 9: "Fall", 10: "Fall", 11: "Fall"}
    last_dom = [(d + datetime.timedelta(1)).month != d.month for d in ds]
    holidays = {(1, 1), (7, 4), (12, 25), (12, 31), (11, 11), (5, 30)}
    date = {
        "d_datekey": Col("int4", key),
        "d_date": text_col([f"{MONTHS[d.month - 1]} {d.day}, {d.year}"
                            for d in ds], np.arange(days)),
        "d_dayofweek": text_col(DAYS, np.array([d.weekday() for d in ds])),
        "d_month": text_col(MONTHS, np.array([d.month - 1 for d in ds])),
        "d_year": i32([d.year for d in ds]),
        "d_yearmonthnum": i32([d.year * 100 + d.month for d in ds]),
        "d_yearmonth": text_col([f"{MONTHS[d.month - 1][:3]}{d.year}"
                                 for d in ds], np.arange(days)),
        "d_daynuminweek": i32([d.weekday() + 1 for d in ds]),
        "d_daynuminmonth": i32([d.day for d in ds]),
        "d_daynuminyear": i32(doy),
        "d_monthnuminyear": i32([d.month for d in ds]),
        "d_weeknuminyear": i32([(y - 1) // 7 + 1 for y in doy]),
        "d_sellingseason": text_col([season.get(d.month, "Spring")
                                     for d in ds], np.arange(days)),
        "d_lastdayinweekfl": i32([int(d.weekday() == 6) for d in ds]),
        "d_lastdayinmonthfl": i32([int(v) for v in last_dom]),
        "d_holidayfl": i32([int((d.month, d.day) in holidays) for d in ds]),
        "d_weekdayfl": i32([int(d.weekday() < 5) for d in ds]),
    }
    return date, key


def generate(cfg: dict, seed: int) -> Dataset:
    n = int(cfg["lineorder_rows"])
    n_cust, n_supp, n_part = (int(cfg["customer_rows"]),
                              int(cfg["supplier_rows"]),
                              int(cfg["part_rows"]))
    days = int(cfg["date_rows"])
    # an order's date leaves room for its lines' commit dates (dbgen:
    # order dates end 151 days before the calendar does)
    order_days = days - 151
    date, datekey = _date(days)
    rng = rng_of(seed, 1)
    tables = {"date": date,
              "customer": _customer(rng, n_cust),
              "supplier": _supplier(rng, n_supp),
              "part": _part(rng, n_part)}

    # orders of 1-7 lines, cut so that the lines number exactly n
    counts = rng.integers(1, 8, n // 4 + n // 8 + 16)
    ends = np.cumsum(counts)
    n_orders = int(np.searchsorted(ends, n)) + 1
    counts = counts[:n_orders]
    counts[-1] -= int(ends[n_orders - 1]) - n
    order_of_row = np.repeat(np.arange(n_orders, dtype=np.int32), counts)
    first_row = (np.cumsum(counts) - counts).astype(np.int64)
    o_cust = rng.integers(1, n_cust + 1, n_orders).astype(np.int32)
    o_day = rng.integers(0, order_days, n_orders).astype(np.int32)
    o_prio = rng.integers(0, 5, n_orders).astype(np.int32)

    i4 = "int32"
    dtypes = {k: i4 for k in (
        "lo_orderkey", "lo_linenumber", "lo_custkey", "lo_partkey",
        "lo_suppkey", "lo_orderdate", "lo_orderpriority", "lo_shippriority",
        "lo_quantity", "lo_extendedprice", "lo_discount", "lo_revenue",
        "lo_supplycost", "lo_tax", "lo_commitdate", "lo_shipmode")}
    dtypes["_gross"] = "int64"

    def fill(r, a, b, out):
        m = b - a
        o = order_of_row[a:b]
        part = r.integers(1, n_part + 1, m, dtype=np.int32)
        qty = r.integers(1, 51, m, dtype=np.int32)
        disc = r.integers(0, 11, m, dtype=np.int32)
        tax = r.integers(0, 9, m, dtype=np.int32)
        price = retail_price(part)
        ext = qty * price
        ext64 = ext.astype(np.int64)
        day = o_day[o]
        out["lo_orderkey"][:] = o + 1
        out["lo_linenumber"][:] = np.arange(a, b) - first_row[o] + 1
        out["lo_custkey"][:] = o_cust[o]
        out["lo_partkey"][:] = part
        out["lo_suppkey"][:] = r.integers(1, n_supp + 1, m, dtype=np.int32)
        out["lo_orderdate"][:] = datekey[day]
        out["lo_orderpriority"][:] = o_prio[o]
        out["lo_shippriority"][:] = 0
        out["lo_quantity"][:] = qty
        out["lo_extendedprice"][:] = ext
        out["lo_discount"][:] = disc
        out["lo_revenue"][:] = ext64 * (100 - disc) // 100
        out["lo_supplycost"][:] = 6 * price // 10
        out["lo_tax"][:] = tax
        out["lo_commitdate"][:] = datekey[day + r.integers(30, 91, m)]
        out["lo_shipmode"][:] = r.integers(0, 7, m, dtype=np.int32)
        out["_gross"][:] = ext64 * (100 - disc) * (100 + tax) // 10000

    cols = parallel_fill(n, seed, 2, dtypes, fill)
    gross = cols.pop("_gross")
    total = np.add.reduceat(gross, first_row)
    del gross
    lo: dict[str, Col] = {}
    for k, v in cols.items():
        if k == "lo_orderpriority":
            lo[k] = Col("text", v, list(PRIORITIES))
        elif k == "lo_shipmode":
            lo[k] = Col("text", v, list(SHIPMODES))
        else:
            lo[k] = Col("int4", v)
        if k == "lo_extendedprice":
            lo["lo_ordtotalprice"] = Col("int8", total[order_of_row])
    tables["lineorder"] = lo
    return Dataset(tables)
