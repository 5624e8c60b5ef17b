"""The port's SQL parser against the reference's, statement for
statement.

Every SQL string in the reference's frontend tests
(``tests/test_{frontend,corpus,subquery_having,plan_rewrite,
session_config}.py``) goes through both parsers: the statements must
come out as equal ASTs (``dataclasses.asdict``), and input one parser
refuses the other must refuse with the same ``ParseError`` message. The
strings are read from the test files' source: implicit concatenations
as Python joins them, f-strings with each placeholder filled by ``7``,
``.format`` templates with each field filled by ``bid``.
"""

import ast as pyast
import dataclasses
import os
import re

import pytest

from risingwave_tpu.frontend import parser as r_parser
from risingwave_tpu_torch.frontend import parser as p_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("test_frontend", "test_corpus", "test_subquery_having",
         "test_plan_rewrite", "test_session_config")
_SQL_START = re.compile(
    r"^\s*(SELECT|CREATE|DROP|SET|SHOW|EXPLAIN|FLUSH|INSERT|DELETE|"
    r"UPDATE|ALTER)\b", re.IGNORECASE)


def _strings(path):
    tree = pyast.parse(open(path).read())
    out = []
    for node in pyast.walk(tree):
        if isinstance(node, pyast.Constant) and isinstance(node.value, str):
            s = node.value
            if "{" in s and "}" in s:
                s = re.sub(r"\{[^{}]*\}", "bid", s)
            out.append(s)
        elif isinstance(node, pyast.JoinedStr):
            out.append("".join(
                v.value if isinstance(v, pyast.Constant) else "7"
                for v in node.values))
    return out


def _corpus():
    seen, cases = set(), []
    for name in FILES:
        for s in _strings(os.path.join(REPO, "tests", name + ".py")):
            if _SQL_START.match(s) and s not in seen:
                seen.add(s)
                cases.append((name, s))
    return cases


CORPUS = _corpus()


def _outcome(parser, sql):
    try:
        stmts = parser.parse_many(sql)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("error", type(e).__name__, str(e))
    return ("ok", [(text, type(s).__name__, dataclasses.asdict(s))
                   for text, s in stmts])


def test_corpus_is_the_reference_tests_sql():
    assert len(CORPUS) > 150
    assert {n for n, _s in CORPUS} == set(FILES)


@pytest.mark.parametrize("idx", range(len(CORPUS)))
def test_statement_parses_as_in_reference(idx):
    _name, sql = CORPUS[idx]
    assert _outcome(p_parser, sql) == _outcome(r_parser, sql)


@pytest.mark.parametrize("sql", [
    "SELECT FROM x",
    "CREATE MATERIALIZED VIEW v SELECT 1",
    "SELECT * FROM (SELECT a FROM t)",
    "SELECT a FROM t WHERE",
    "CREATE SOURCE s WITH (connector=)",
    "SELECT 'unterminated FROM t",
    "DROP TABLE",
    "SET x",
    "SELECT a b c FROM t",
    "SELECT * FROM TUMBLE(bid, date_time, INTERVAL 'x' SECOND)",
])
def test_parser_errors_match_reference(sql):
    """Bad input: the same error class and message in both."""
    got = _outcome(p_parser, sql)
    assert got == _outcome(r_parser, sql)
    assert got[0] == "error"
