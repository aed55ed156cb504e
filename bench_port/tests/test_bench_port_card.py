"""The cell on the card, briefly: a traced run reads every per-layer
metric and is correct.  Needs a CUDA device and skips without one:

    python -m pytest -m gpu bench_port/tests/test_bench_port_card.py
"""

import pytest

import run as bench


@pytest.mark.gpu
def test_traced_cell_reads_every_layer(cuda_device):
    cell, traffic, config, spec = bench.load_cell("prrn-protein.rv12")
    res = bench.run_cell(cell, traffic, config, spec["per_layer"], seed=7,
                         seconds=1.0, trace=True, device=cuda_device.type)
    assert res["correct"] is True
    assert set(res["metrics"]) == {m["name"] for m in spec["per_layer"]}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
