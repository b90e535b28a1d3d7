"""The one traffic generator: a mix file's templates, round robin, with
constants drawn from the seed.

A mix (`portbench/traffic/<name>.json`) lists templates.  Each has a SQL
text with `{param}` holes, its params in draw order, the fact table whose
rows every query covers, the columns it reads (`reads`, for the logical
bytes), and a `reference` spec that `portbench/reference/` evaluates.
The templates run in a fixed round robin, a template with "weight": w
w times a turn, so each template's share of a window is fixed; the
constants come from one stream of the seed.

Param kinds, each drawn or derived in list order:
  {"uniform": [lo, hi], "decimals": d}   a float, rounded to d decimals
  {"int": [lo, hi]}                       an integer, both ends included
  {"choice": [v, ...]}                    one of the values
  {"cycle": [v, ...]}                     the values in turn, from an
                                          offset drawn once: exact shares
  {"add": [param, k]}                     an earlier param plus k
  {"format": "text {param}"}             a string from earlier params
A param with "warm_all": true is a shape: set-up warms every template once
for each of its values (and each combination with other such params).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterator

import numpy as np

from portbench.lib.dataset import rng_of

TRAFFIC_STREAM = 1
WARM_STREAM = 3


@dataclasses.dataclass(frozen=True)
class Query:
    index: int
    template: str
    sql: str
    params: dict


def draw(spec: dict, rng: np.random.Generator, params: dict,
         turn: int = 0) -> Any:
    if "cycle" in spec:
        vals = spec["cycle"]
        return vals[turn % len(vals)]
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return round(float(rng.uniform(lo, hi)), int(spec.get("decimals", 2)))
    if "int" in spec:
        lo, hi = spec["int"]
        return int(rng.integers(lo, hi + 1))
    if "choice" in spec:
        vals = spec["choice"]
        return vals[int(rng.integers(0, len(vals)))]
    if "add" in spec:
        name, k = spec["add"]
        return params[name] + k
    if "format" in spec:
        return spec["format"].format(**params)
    raise ValueError(f"unknown param kind: {spec}")


def instantiate(tpl: dict, rng: np.random.Generator,
                fixed: dict | None = None, turn: int = 0) -> dict:
    params: dict = {}
    for name, spec in tpl["params"]:
        if fixed and name in fixed:
            params[name] = fixed[name]
        else:
            params[name] = draw(spec, rng, params, turn)
    return params


def render(tpl: dict, params: dict) -> str:
    return tpl["sql"].format(**params)


def turn_order(mix: dict) -> list[int]:
    """The templates of one turn of the round robin, by index."""
    tpls = mix["templates"]
    most = max(int(t.get("weight", 1)) for t in tpls)
    return [k for w in range(most) for k, t in enumerate(tpls)
            if int(t.get("weight", 1)) > w]


def queries(mix: dict, seed: int) -> Iterator[Query]:
    """The window's queries, in order, without end."""
    rng = rng_of(seed, TRAFFIC_STREAM)
    tpls = mix["templates"]
    offset = [int(rng.integers(0, 1 << 16)) for _ in tpls]
    order = turn_order(mix)
    seen = [0] * len(tpls)
    for i in itertools.count():
        k = order[i % len(order)]
        tpl = tpls[k]
        params = instantiate(tpl, rng, turn=offset[k] + seen[k])
        seen[k] += 1
        yield Query(i, tpl["name"], render(tpl, params), params)


def warmup_queries(mix: dict, seed: int) -> list[Query]:
    """One query for each template and each combination of its shape
    params, with the other constants drawn from a stream of their own."""
    rng = rng_of(seed, WARM_STREAM)
    out: list[Query] = []
    for tpl in mix["templates"]:
        shapes = [(n, s.get("choice", s.get("cycle"))) for n, s in
                  tpl["params"] if s.get("warm_all")]
        for combo in itertools.product(*[v for _, v in shapes]):
            fixed = {n: v for (n, _), v in zip(shapes, combo)}
            params = instantiate(tpl, rng, fixed)
            out.append(Query(-1 - len(out), tpl["name"],
                             render(tpl, params), params))
    return out


def template(mix: dict, name: str) -> dict:
    return next(t for t in mix["templates"] if t["name"] == name)
