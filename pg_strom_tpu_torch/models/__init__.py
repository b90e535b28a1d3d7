"""Workload models: regression fixtures and benchmark schemas.

The analog of the reference's test/bench data definitions:
  fixtures.py  — gpupreagg_test-style tables (input/sql/agg_init.sql analog)
  testdb.py    — t0 fact + t1..t5 dimension star schema (testdb.sql analog)

The reference's pg_fixture.py (PostgreSQL-seeded regression tables) waits
for the port's native/ module, whose PgRandom it draws from (ROADMAP queue
1, item 7 "native/ and COPY").
"""
