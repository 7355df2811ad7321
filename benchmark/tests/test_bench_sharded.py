"""A cell whose traffic names a function of the package by its dotted
path, with a mesh: the sharded search on a CPU mesh of four shards, run
by the harness, comes out ``correct``; the mesh is built once a run; and
the check fails the run where the sharded path is broken underneath."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests import fixture_cell

SHARDED = dict(
    api="parallel.align_arrays_sharded", mesh="parallel.device_mesh",
    chips=4, per_call=3, lengths=(24, 40, 70),
)


def sharded_database():
    # more than four blocks of 128 targets, so that every shard holds
    # some
    return fixture_cell.tiny_database(count=520, median=40, clip=(20, 120))


def run(tmp_path, monkeypatch, **kw):
    return fixture_cell.run(
        tmp_path, monkeypatch, database=sharded_database(), **SHARDED, **kw
    )


@pytest.mark.parametrize("traced", [False, True])
def test_sharded_cell_runs(tmp_path, monkeypatch, traced):
    from pyopal_tpu_torch import parallel

    built, seen = [], set()
    real_mesh = parallel.device_mesh
    real_fn = parallel.align_arrays_sharded

    def mesh(*a, **kw):
        built.append((a, kw))
        return real_mesh(*a, **kw)

    def fn(queries, db, **kw):
        seen.add(id(kw["mesh"]))
        assert kw["scoring_matrix"] == "BLOSUM50"
        assert (kw["gap_open"], kw["gap_extend"]) == (3, 1)
        return real_fn(queries, db, **kw)

    monkeypatch.setattr(parallel, "device_mesh", mesh)
    monkeypatch.setattr(parallel, "align_arrays_sharded", fn)
    out = run(tmp_path, monkeypatch, traced=traced)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert built == [((4,), {"device": "cpu"})]
    assert len(seen) == 1
    assert out["device"]["count"] == 4
    if traced:
        assert len(out["cards"]["busy_s"]) == 4
        assert {"gcups", "setup_s"}.isdisjoint(out["metrics"])
        assert "host_ms.gcups" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"gcups", "setup_s"}


def stale(monkeypatch):
    """A call that returns the previous call's answers."""
    from pyopal_tpu_torch import parallel

    real = parallel.align_arrays_sharded
    memo = {}

    def fake(queries, db, **kw):
        out = memo.get("last") or real(queries, db, **kw)
        memo["last"] = real(queries, db, **kw)
        return out

    monkeypatch.setattr(parallel, "align_arrays_sharded", fake)


def half(monkeypatch):
    """Half of each call's queries left out: their rows never computed."""
    from pyopal_tpu_torch import parallel

    real = parallel.align_arrays_sharded

    def fake(queries, db, **kw):
        keep = max(1, len(queries) // 2)
        out = real(queries[:keep], db, **kw)
        s = out["scores"]
        pad = np.zeros((len(queries) - keep, s.shape[1]), s.dtype)
        return {"scores": np.concatenate([s, pad])}

    monkeypatch.setattr(parallel, "align_arrays_sharded", fake)


def exchange(monkeypatch):
    """The exchange between shards left out: only the home shard's
    outputs come back, the others' stay zero."""
    from pyopal_tpu_torch.parallel import sharded_flat

    real = sharded_flat._gather_host

    def fake(mesh, local):
        out = real(mesh, local)
        out[1:] = 0
        return out

    monkeypatch.setattr(sharded_flat, "_gather_host", fake)


def altered(monkeypatch):
    """One answer altered where each shard's kernel produces it."""
    from pyopal_tpu_torch.ops import q8, ragged

    for mod, name in ((q8, "search_flat_q8"), (ragged, "search_flat")):
        real = getattr(mod, name)

        def fake(*a, _real=real, **kw):
            s, qe, te = _real(*a, **kw)
            s = s.clone()
            s.view(-1)[0] += 1
            return s, qe, te

        monkeypatch.setattr(mod, name, fake)


@pytest.mark.parametrize("fault", [stale, half, exchange, altered])
def test_fault_fails_the_check(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    out = run(tmp_path, monkeypatch, seconds=0.6)
    assert out["correct"] is False
    assert out["check"]["score_mismatches"]["value"] > 0


@pytest.mark.parametrize("api", [
    "parallel.no_such_function", "no_such_module.align", "parallel.mesh.DB_AXIS",
])
def test_unknown_function_fails_clearly(tmp_path, monkeypatch, api):
    with pytest.raises(harness.Failure) as err:
        fixture_cell.run(tmp_path, monkeypatch, api=api)
    assert err.value.code == 2
    assert f"pyopal_tpu_torch has no function {api!r}" in str(err.value)
