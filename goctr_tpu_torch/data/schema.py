"""Database schema scanners + row cursors (port of
goctr_tpu/data/schema.py).

Parity with the reference's schema/ package (TableScanner scan.go:7-10; SQLite
PRAGMA table_info introspection sqlite.go:32-66; MySQL SHOW CREATE TABLE
mysql.go:78-107). SQLite uses the standard library's sqlite3; MySQL needs
the optional pymysql package, which the port does not bundle.
"""
from __future__ import annotations

import dataclasses
import re
import sqlite3
from typing import Any, Iterator, Protocol, Sequence


@dataclasses.dataclass
class Column:
    name: str
    type: str
    nullable: bool = True
    primary_key: bool = False
    size: str = ""
    comment: str = ""


class TableScanner(Protocol):
    def get_schema(self, table: str) -> list[Column]: ...

    def scan_rows(self, query: str,
                  params: Sequence[Any] = ()) -> Iterator[tuple]: ...


class SqliteScanner:
    """SQLite schema scanner (reference sqlite.go)."""

    def __init__(self, path: str, read_only: bool = True):
        uri = f"file:{path}?mode=ro" if read_only else path
        self.conn = sqlite3.connect(uri, uri=read_only,
                                    check_same_thread=False)

    def get_schema(self, table: str) -> list[Column]:
        cur = self.conn.execute(f"PRAGMA table_info({table})")
        cols = []
        for _, name, ctype, notnull, _, pk in cur.fetchall():
            cols.append(Column(name=name, type=(ctype or "").upper(),
                               nullable=not notnull, primary_key=bool(pk)))
        if not cols:
            raise ValueError(f"table {table!r} not found")
        return cols

    def tables(self) -> list[str]:
        cur = self.conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")
        return [r[0] for r in cur.fetchall()]

    def scan_rows(self, query: str,
                  params: Sequence[Any] = ()) -> Iterator[tuple]:
        cur = self.conn.execute(query, tuple(params))
        while True:
            rows = cur.fetchmany(4096)
            if not rows:
                return
            yield from rows

    def close(self):
        self.conn.close()


class MysqlScanner:
    """MySQL scanner; requires the optional pymysql package."""

    def __init__(self, dsn: str):
        try:
            import pymysql  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "MySQL support needs pymysql (not bundled); use "
                "SqliteScanner or install pymysql") from e
        import pymysql
        self.conn = pymysql.connect(**_parse_mysql_dsn(dsn))

    def get_schema(self, table: str) -> list[Column]:
        with self.conn.cursor() as cur:
            cur.execute(
                "SELECT column_name, data_type, is_nullable, column_key "
                "FROM information_schema.columns WHERE table_name=%s "
                "ORDER BY ordinal_position", (table,))
            cols = [Column(name=r[0], type=r[1].upper(),
                           nullable=r[2] == "YES", primary_key=r[3] == "PRI")
                    for r in cur.fetchall()]
        if not cols:
            raise ValueError(f"table {table!r} not found")
        return cols

    def scan_rows(self, query: str,
                  params: Sequence[Any] = ()) -> Iterator[tuple]:
        with self.conn.cursor() as cur:
            cur.execute(query, tuple(params))
            while True:
                rows = cur.fetchmany(4096)
                if not rows:
                    return
                yield from rows


def _mask_literals(s: str) -> str:
    """Blank the contents of '...' string literals (honoring '' and \\'
    escapes) and `...` quoted identifiers, preserving length, so structural
    scans (paren depth, comma splits, keyword checks) can't be fooled by
    quotes/commas/parens inside COMMENT/DEFAULT text or column names."""
    out = list(s)
    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "'":
            j = i + 1
            while j < n:
                if s[j] == "\\" and j + 1 < n:        # \' (and \\ etc.)
                    out[j] = out[j + 1] = " "
                    j += 2
                    continue
                if s[j] == "'":
                    if j + 1 < n and s[j + 1] == "'":  # '' escape
                        out[j] = out[j + 1] = " "
                        j += 2
                        continue
                    break
                out[j] = " "
                j += 1
            i = j + 1
        elif ch == "`":
            j = i + 1
            while j < n and s[j] != "`":
                out[j] = " "
                j += 1
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _split_top_level(text: str, masked: str) -> list[tuple[str, str]]:
    """Split on commas at paren depth 0 (depth computed on the masked
    twin); returns (original, masked) fragment pairs, stripped in sync."""
    frags: list[tuple[str, str]] = []
    depth, start = 0, 0
    for i, ch in enumerate(masked):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            frags.append((text[start:i], masked[start:i]))
            start = i + 1
    frags.append((text[start:], masked[start:]))
    out = []
    for orig, msk in frags:
        lead = len(orig) - len(orig.lstrip())
        trail = len(orig) - len(orig.rstrip())
        end = len(orig) - trail
        if orig.strip():
            out.append((orig[lead:end], msk[lead:end]))
    return out


# Word-boundary match so a column named e.g. `key_id` (unquoted) is not
# misclassified as an index definition (reference's sqlparser gets this
# right via real tokenization, mysql.go:117-151).
_CONSTRAINT_RE = re.compile(
    r"(?i)(PRIMARY\s+KEY|UNIQUE(?:\s+KEY|\s+INDEX)?|KEY|INDEX|CONSTRAINT|"
    r"FOREIGN\s+KEY|FULLTEXT|SPATIAL|CHECK)\b")


def parse_mysql_ddl(ddl: str) -> tuple[str, list[Column]]:
    """Parse `SHOW CREATE TABLE` output into (table_name, columns).

    Pure-function twin of the reference's sqlparser-backed ParseMysqlDDL
    (the reference's schema/mysql.go:117-151): extracts per-column name,
    base type, declared length/size, COMMENT, NOT NULL, and PRIMARY KEY
    membership (including composite keys with prefix lengths). All
    structural scanning is literal-aware: commas/parens/keywords inside
    '...' strings or `...` identifiers never affect parsing. Raises
    ValueError on non-CREATE statements (ErrNotDDL).
    """

    text = ddl.strip()
    masked = _mask_literals(text)
    m = re.match(r"(?is)CREATE\s+(?:TEMPORARY\s+)?TABLE\s+(?:IF\s+NOT\s+"
                 r"EXISTS\s+)?[`\"]?([\w$]+)[`\"]?\s*\(", text)
    if not m:
        raise ValueError("not a CREATE TABLE statement")
    table = m.group(1)
    body_start = m.end() - 1
    # body = balanced (...) after the table name, literal-aware
    depth, end = 0, -1
    for i in range(body_start, len(masked)):
        if masked[i] == "(":
            depth += 1
        elif masked[i] == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    if end < 0:
        raise ValueError("unbalanced CREATE TABLE body")
    body = text[body_start + 1:end]
    mbody = masked[body_start + 1:end]

    def pk_members(d: str, md: str) -> set[str]:
        """Column names from a PRIMARY KEY (...) list; handles composite
        keys with prefix lengths like (`name`(10),`id`)."""
        lp = md.find("(")
        if lp < 0:
            return set()
        depth = 0
        rp = -1
        for i in range(lp, len(md)):
            if md[i] == "(":
                depth += 1
            elif md[i] == ")":
                depth -= 1
                if depth == 0:
                    rp = i
                    break
        if rp < 0:
            return set()
        names = set()
        for orig, _ in _split_top_level(d[lp + 1:rp], md[lp + 1:rp]):
            orig = re.sub(r"\(\s*\d+\s*\)\s*$", "", orig.strip())  # (N) prefix
            names.add(orig.strip(" `\""))
        return names

    cols: list[Column] = []
    pk_names: set[str] = set()
    for d, md in _split_top_level(body, mbody):
        mupper = md.upper()
        # constraint defs never start with a quoted identifier; column defs
        # whose unquoted name merely starts with KEY/CHECK/... don't match
        # the word-boundary regex
        if not d.startswith(("`", '"')) and _CONSTRAINT_RE.match(md):
            if mupper.startswith("PRIMARY"):
                pk_names = pk_members(d, md)
            continue
        cm = re.match(r"[`\"]?([\w$]+)[`\"]?\s+([\w]+)(?:\(([^)]*)\))?", d)
        if not cm:
            continue
        name, ctype, size = cm.group(1), cm.group(2).lower(), cm.group(3) or ""
        comment_m = re.search(r"(?i)COMMENT\s+'((?:[^'\\]|''|\\.)*)'", d)
        comment = ""
        if comment_m:
            comment = (comment_m.group(1).replace("''", "'")
                       .replace("\\'", "'").replace("\\\\", "\\"))
        cols.append(Column(
            name=name, type=ctype,
            nullable="NOT NULL" not in mupper,
            primary_key="PRIMARY KEY" in mupper,
            size=size.strip(),
            comment=comment))
    for c in cols:
        if c.name in pk_names:
            c.primary_key = True
    if not cols:
        raise ValueError("CREATE TABLE with no parseable columns")
    return table, cols


def _parse_mysql_dsn(dsn: str) -> dict:
    """user:pass@host:port/dbname (reference Go DSN style)."""
    creds, _, rest = dsn.rpartition("@")
    user, _, password = creds.partition(":")
    hostport, _, db = rest.partition("/")
    host, _, port = hostport.partition(":")
    return {"user": user or "root", "password": password,
            "host": host or "localhost", "port": int(port or 3306),
            "database": db}
