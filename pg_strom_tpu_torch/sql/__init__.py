"""SQL frontend: lexer, parser, binder, and the top-level execute().

The reference plugs into PostgreSQL's parser/planner via hooks (grafter.c
planner_hook, add_scan_path_hook, add_hashjoin_path_hook); a standalone
engine needs its own SQL surface.  The dialect covers the reference's
regression corpus (SELECT with expressions, WHERE, JOIN ... ON / comma
joins, GROUP BY, ORDER BY, LIMIT, casts, CASE, aggregates) — enough that a
pg_strom user's queries run unchanged.
"""

from .api import execute, explain  # noqa: F401
