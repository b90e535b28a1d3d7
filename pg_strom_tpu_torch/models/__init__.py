"""Workload models: regression fixtures and benchmark schemas.

The analog of the reference's test/bench data definitions:
  fixtures.py   — gpupreagg_test-style tables (input/sql/agg_init.sql analog)
  testdb.py     — t0 fact + t1..t5 dimension star schema (testdb.sql analog)
  pg_fixture.py — the PostgreSQL-seeded regression tables, bit-exact
                  (drawn from native.PgRandom, glibc random())
"""

from .pg_fixture import (  # noqa: F401
    regen_preagg_test, regen_preagg_overflow, regen_preagg_mix)
