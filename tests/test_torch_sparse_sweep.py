"""The port's density sweep (python -m pilosa_tpu_torch.tools.sparse_sweep)
against the JAX package's tools/sparse_sweep.py: on the CPU at 2 slices
it passes its gates (the card path's answer equals the host fold's C++
kernels, the format matches the density), writes the JAX tool's report
keys, gives the same formats and staged bytes' split, and exits 1 when
the served answer is off (a delta at the device.exec result seam) or the
format contradicts the density.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.tools import common, sparse_sweep
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--device", "cpu", "--slices", "2", "--iters", "1"]


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sweep") / "report.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(REPO / "tools" /
                                            "sparse_sweep.py"),
                        "--slices", "2", "--iters", "1", "--out", str(out)],
                       env=env, capture_output=True, text=True, timeout=600,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def test_the_sweep_passes_with_the_jax_tools_report(tmp_path, jax_report):
    out = tmp_path / "SPARSE_SWEEP.json"
    assert sparse_sweep.main(ARGS + ["--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and rep["failures"] == []
    assert set(rep) == set(jax_report)
    assert set(rep["sweep"]) == set(jax_report["sweep"]) \
        == {"0.003", "0.03", "0.3"}
    for d, row in rep["sweep"].items():
        jrow = jax_report["sweep"][d]
        assert set(row) == set(jrow)
        assert row["device_vs_host_exact"] is True
        assert row["format"] == jrow["format"]
        assert (row["staged_sparse_bytes"] > 0) == \
            (jrow["staged_sparse_bytes"] > 0)
    assert [rep["sweep"][d]["format"] for d in ("0.003", "0.03", "0.3")] \
        == ["sparse", "sparse", "dense"]
    assert rep["slices"] == 2 and rep["iters"] == 1


def test_the_holder_draws_bench_pys_bits(tmp_path):
    """The same seeded containers as bench.py's build_sparse_holder."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import bench  # the JAX package's bench, for its holder

    for density in (0.003, 0.3):
        th = common.build_sparse_holder(str(tmp_path / "t"), 2, density)
        jh = bench.build_sparse_holder(str(tmp_path / "j"), 2, density)
        try:
            for s in range(2):
                a = th.fragment("i", "general", "standard", s).storage
                b = jh.fragment("i", "general", "standard", s).storage
                assert a.keys == b.keys
                assert [c.values().tolist() for c in a.containers] == \
                    [c.values().tolist() for c in b.containers]
        finally:
            th.close()
            jh.close()


def test_an_injected_mismatch_exits_1(tmp_path, capsys):
    out = tmp_path / "r.json"
    fault.arm("device.exec", delta=3, kind="count-result")
    try:
        rc = sparse_sweep.main(ARGS + ["--densities", "0.03",
                                       "--out", str(out)])
    finally:
        fault.reset()
    assert rc == 1
    rep = json.loads(out.read_text())
    assert rep["ok"] is False
    assert rep["sweep"]["0.03"]["device_vs_host_exact"] is False
    assert any("device" in f and "!= host" in f for f in rep["failures"])
    assert "FAIL: density 0.03" in capsys.readouterr().err


def test_a_contradicting_format_exits_1(tmp_path, monkeypatch):
    """A stager that kept a 3% workload dense is broken, not slow."""
    from pilosa_tpu_torch.parallel import serve

    monkeypatch.setattr(serve, "resident_format", lambda sv: "dense")
    out = tmp_path / "r.json"
    assert sparse_sweep.main(ARGS + ["--densities", "0.03",
                                     "--out", str(out)]) == 1
    rep = json.loads(out.read_text())
    assert rep["failures"] == ["density 0.03: staged dense, expected sparse"]
