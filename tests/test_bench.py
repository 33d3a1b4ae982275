"""bench.py's guards: it measures only on a GPU it knows."""

import bench


def test_refuses_without_a_gpu(capsys):
    assert bench.main(["--only", "floor"]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "no GPU" in err


def test_bandwidth_table_lists_only_h100_kinds():
    assert set(bench.HBM_BYTES_PER_S) == {
        "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL",
    }
    assert all(2e12 <= bw <= 4e12 for bw in bench.HBM_BYTES_PER_S.values())


def test_level_sweep_says_why_it_skipped(monkeypatch):
    monkeypatch.delenv("HGI_REFERENCE_RES", raising=False)
    result = bench.measure_levels(1)
    assert "HGI_REFERENCE_RES" in result["skipped"]
