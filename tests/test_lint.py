"""In-repo lint floor (the reference enforces 80 columns + style via
UnitTests/lint.sh:7-31; full flake8 runs in CI where it is installable).
"""
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MAX_COLS = 79


def python_sources():
    for sub in ("ntpoly_tpu", "tests", "examples"):
        yield from (ROOT / sub).rglob("*.py")
    yield ROOT / "bench.py"
    yield ROOT / "chip_smoke.py"
    yield ROOT / "__graft_entry__.py"


def test_line_length_and_whitespace():
    problems = []
    for path in python_sources():
        for n, line in enumerate(path.read_text().splitlines(), 1):
            rel = path.relative_to(ROOT)
            if len(line) > MAX_COLS:
                problems.append(f"{rel}:{n}: line too long ({len(line)})")
            if line != line.rstrip():
                problems.append(f"{rel}:{n}: trailing whitespace")
            if "\t" in line:
                problems.append(f"{rel}:{n}: tab character")
    assert not problems, "\n".join(problems[:40])


def test_no_bare_todo_stubs():
    """No NotImplementedError placeholders or TODO stubs in the package."""
    pat = re.compile(r"raise NotImplementedError|# TODO\b")
    hits = []
    for path in (ROOT / "ntpoly_tpu").rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if pat.search(line):
                hits.append(f"{path.relative_to(ROOT)}:{n}")
    assert not hits, "\n".join(hits)
