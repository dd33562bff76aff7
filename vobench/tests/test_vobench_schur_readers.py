"""The reader of the refine's sparse reductions (``sparse_schur_steps``) on
a hand-made trace of two refines, and what it reads on a program whose
reductions are all dense, or with no refine."""

import pytest

from vobench import manifest
from vobench.trace import PREFIX, Ev, Trace

MS = 1_000_000  # ns


def _refines(steps=3):
    """A slice of 0-100 ms with two refines (0-40 ms, 50-90 ms), each with
    ``steps`` sparse reductions, and two more outside both (a solve of
    another caller)."""
    host = [Ev(PREFIX + "slice", 0, 100 * MS, 0), Ev("tpuvo.refine", 0, 40 * MS, 0),
            Ev("tpuvo.refine", 50 * MS, 90 * MS, 0)]
    for t0 in (1, 51):
        host += [Ev("tpuvo.ba.schur.sparse", (t0 + 2 * k) * MS, (t0 + 2 * k + 1) * MS, 0)
                 for k in range(steps)]
    host += [Ev("tpuvo.ba.schur.sparse", t * MS, (t + 1) * MS, 0) for t in (45, 95)]
    return Trace(host, [], {})


def _read(tr):
    return manifest.reader("sparse_schur_steps")(dict(trace=tr))


@pytest.mark.parametrize("case", ["sparse", "dense", "no refine"])
def test_sparse_schur_steps(case):
    """3 sparse reductions in each refine (those outside the refines not
    counted); a program whose reductions are dense (a parent): 0 a refine;
    no refine span at all: nothing to divide by."""
    tr = _refines()
    if case == "sparse":
        assert _read(tr) == pytest.approx(3.0)
    elif case == "dense":
        tr = Trace([e for e in tr.host if e.name != "tpuvo.ba.schur.sparse"], [], {})
        assert _read(tr) == 0.0
    else:
        tr = Trace([e for e in tr.host if e.name != "tpuvo.refine"], [], {})
        assert _read(tr) is None
