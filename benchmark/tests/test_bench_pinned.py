"""The existing cells build the same database and draw the same queries
as before configurations brought their own letters, and their check
still reaches `reference.sw_scores`: digests of the CPU's draws frozen
from the tree before that change."""

import hashlib
import json

import numpy as np
import pytest

from benchmark import check, generate, harness, reference, reference_dp
from benchmark.tests import fixture_cell

#: each traffic file with its cell's configuration
CELLS = {
    "batch256": "sprot12071-blosum50",
    "proteome64": "sprot12071-blosum50",
    "query": "swissprot-blosum62",
    "cudasw20": "swissprot-blosum62",
    "cudasw20_sharded": "swissprot-blosum62",
}
SEEDS = (2**31 + 7, 987654321)
FROZEN = {
    "sprot12071-blosum50/2147483655": "96880cfe61c6457d",
    "batch256/2147483655": "d0e7b93b34dfcb1d",
    "proteome64/2147483655": "7af23ef49204eca9",
    "swissprot-blosum62/2147483655": "eb832e5d60dabd78",
    "query/2147483655": "5004f857926258cf",
    "cudasw20/2147483655": "da11a65be9ffeb56",
    "cudasw20_sharded/2147483655": "da11a65be9ffeb56",
    "sprot12071-blosum50/987654321": "fbd3d76300c0467d",
    "batch256/987654321": "bb69b63ba950c85f",
    "proteome64/987654321": "7ff75060090eefec",
    "swissprot-blosum62/987654321": "3397555774a32997",
    "query/987654321": "0acecc5207ebd512",
    "cudasw20/987654321": "2a0b0053ac0410f1",
    "cudasw20_sharded/987654321": "2a0b0053ac0410f1",
}


def load(kind, name):
    return json.loads((fixture_cell.BENCH / kind / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", sorted(set(CELLS.values())))
def test_database_and_first_calls_unchanged(config, seed):
    cfg = load("configs", config)
    data = harness.Data(cfg, seed, "cpu")
    h = hashlib.sha256(data.codes.tobytes())
    h.update(b"".join(
        a.tobytes()
        for a in generate.ascii_sequences(data.codes, data.lengths, data.letters)
    ))
    assert h.hexdigest()[:16] == FROZEN[f"{config}/{seed}"]
    for traffic_name in (t for t, c in CELLS.items() if c == config):
        traffic = load("traffic", traffic_name)
        assert check.judged(traffic, cfg["scoring"]) == ("sw", "score")
        call = data.queries(traffic, seed, generate.STREAM_WINDOW).call(0)
        h = hashlib.sha256(np.asarray(call.starts, np.int64).tobytes())
        h.update(b"\n".join(call.letters))
        h.update(np.concatenate(call.codes).tobytes())
        assert h.hexdigest()[:16] == FROZEN[f"{traffic_name}/{seed}"], traffic_name


def test_sw_score_cell_checked_by_sw_scores(tmp_path, monkeypatch):
    real, seen = reference.sw_scores, []

    def counted(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("an sw score-mode cell reached reference_dp")

    monkeypatch.setattr(reference, "sw_scores", counted)
    monkeypatch.setattr(reference_dp, "search", refused)
    out = fixture_cell.run(tmp_path, monkeypatch)
    assert out["correct"] is True
    assert seen and list(out["check"]) == [
        "score_mismatches", "index_mismatches", "failed_calls"
    ]
