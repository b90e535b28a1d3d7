"""Interactive SQL shell — the psql-facing surface of the engine.

    python -m pg_strom_tpu_torch [script.sql ...]

Statements end with ';'.  Backslash commands:
    \\q            quit
    \\d [table]    list tables / describe one
    \\timing       toggle per-query wall time
    \\i file       run a script (statements and backslash commands)
    \\demo [N]     load the testdb star schema (N fact rows, default 100k)
    \\set ...      alias for SET

The reference is a PostgreSQL extension and rides psql; this engine is the
whole database, so it ships its own shell.  The shell runs on
`config.device` ("cuda" by default): without a GPU it raises at start, as
every entry point of the port does, unless the device is set to "cpu".
"""

from __future__ import annotations

import sys
import time

from .datastore import Database
from .exec.devcache import device
from .errors import SqlError
from .sql import execute
from .sql.parser import ParseError


def _fmt_table(cols: list[str], rows: list[tuple], types) -> str:
    from .utils.pgformat import value_out
    cells = [[value_out(v, t, -3) if v is not None else ""
              for v, t in zip(r, types)] for r in rows]
    widths = [max([len(c)] + [len(row[i]) for row in cells])
              for i, c in enumerate(cols)]
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(c.ljust(w) for c, w in zip(cols, widths)), sep]
    for row in cells:
        out.append(" | ".join(c.ljust(w) for c, w in zip(row, widths)))
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


class Shell:
    def __init__(self) -> None:
        self.device = device()
        self.db = Database()
        self.timing = False

    def run_stmt(self, sql: str) -> None:
        sql = sql.strip().rstrip(";").strip()
        if not sql:
            return
        t0 = time.perf_counter()
        try:
            r = execute(sql, self.db)
        except (SqlError, ParseError, KeyError) as e:
            print(f"ERROR:  {e}")
            return
        dt = (time.perf_counter() - t0) * 1e3
        if r.columns:
            print(_fmt_table(r.columns, r.rows, r.types))
        else:
            print(r.command)
        if self.timing:
            print(f"Time: {dt:.3f} ms")

    def backslash(self, line: str) -> bool:
        """Returns False to quit."""
        parts = line.split()
        cmd = parts[0]
        if cmd in ("\\q", "\\quit"):
            return False
        if cmd == "\\timing":
            self.timing = not self.timing
            print(f"Timing is {'on' if self.timing else 'off'}.")
        elif cmd == "\\d":
            if len(parts) > 1:
                try:
                    t = self.db.get(parts[1])
                except KeyError as e:
                    print(f"ERROR:  {e}")
                    return True
                print(f'Table "{parts[1]}"')
                for cn in t.column_names:
                    print(f"  {cn:24s} {t.columns[cn].type.value}")
                print(f"  ({t.nrows} rows)")
            else:
                for name, t in sorted(self.db.tables.items()):
                    print(f"  {name:24s} {t.nrows:>12} rows  "
                          f"{len(t.column_names)} cols")
                if not self.db.tables:
                    print("No relations found.")
        elif cmd == "\\i" and len(parts) > 1:
            self.run_file(parts[1])
        elif cmd == "\\demo":
            n = int(parts[1]) if len(parts) > 1 else 100_000
            from .models.testdb import build_testdb
            t0 = time.perf_counter()
            build_testdb(self.db, fact_rows=n, dim_rows=min(40_000, n))
            print(f"testdb loaded: t0 ({n} rows) + t1..t5 dims "
                  f"[{time.perf_counter()-t0:.2f}s]")
        else:
            print(f'invalid command {cmd} (try \\d, \\timing, \\i, \\demo, \\q)')
        return True

    def run_file(self, path: str) -> None:
        """Run a script: statements end with ';', and a line that starts
        with a backslash between statements is a command, as psql -f runs
        it (\\q ends the script)."""
        with open(path) as f:
            buf = ""
            for line in f:
                if line.strip().startswith("--"):
                    continue
                if not buf.strip() and line.strip().startswith("\\"):
                    if not self.backslash(line.strip()):
                        return
                    continue
                buf += line
                while ";" in buf:
                    stmt, buf = buf.split(";", 1)
                    self.run_stmt(stmt)

    def repl(self) -> None:
        try:
            import readline  # noqa: F401
        except ImportError:
            pass
        print(f"pg_strom_tpu_torch shell on {self.device} — \\demo loads "
              "the benchmark schema, \\q quits.")
        buf = ""
        while True:
            try:
                prompt = "strom=# " if not buf else "strom-# "
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not buf and line.strip().startswith("\\"):
                if not self.backslash(line.strip()):
                    break
                continue
            buf += line + "\n"
            while ";" in buf:
                stmt, buf = buf.split(";", 1)
                self.run_stmt(stmt)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    sh = Shell()
    if argv:
        for path in argv:
            sh.run_file(path)
        return
    sh.repl()


if __name__ == "__main__":
    main()
