"""The start-up kernel check (pilosa_tpu_torch/ops/calibrate.py) against
the JAX package's calibration (pilosa_tpu/ops/calibrate.py), after
tests/test_calibrate.py.

Off the card the JAX package's forced measurement and the port's check
run the same machinery end to end (the port's wrappers run their plain
versions on CPU tensors, the JAX package's Pallas kernels run in
interpret mode) at equal shapes. Where the JAX package answers "xla" (a
raised measurement, a check mismatch), the port records the failure and
raises, and server.check_card refuses to start. A card is faked where
check_card needs one: the canary and the device name are patched and the
measurements run on the CPU. Record values are compared exactly
(tolerance 0): shapes, sources, verdicts and keys; timings only for
being positive.
"""

import shutil
import threading

import pytest
import torch

from pilosa_tpu.ops import calibrate as jcal
from pilosa_tpu.ops import kernels as jkernels

from pilosa_tpu_torch import server as tserver
from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import calibrate as tcal
from pilosa_tpu_torch.ops import kernels as tkernels
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RECORD_KEYS = {"backend", "source", "pallas_ms", "xla_ms", "shape",
               "interpret", "device", "elapsed_ms"}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for name in ("COUNT_BACKEND", "SPARSE_BACKEND", "CALIBRATION_FILE",
                 "CALIBRATE", "CALIBRATE_TIMEOUT_S", "CALIBRATE_SLICES",
                 "CALIBRATE_ROWS"):
        monkeypatch.delenv("PILOSA_TPU_" + name, raising=False)
    jcal.reset_for_tests()
    tcal.reset_for_tests()
    yield
    jcal.reset_for_tests()
    tcal.reset_for_tests()


class FakeExecutor:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)


@pytest.fixture
def fake_card(monkeypatch):
    """check_card on a faked card: the canary answers True, the device is
    `cuda:test card`, and both measurements run on the CPU."""
    monkeypatch.setattr(tkernels, "probe_ok", lambda dev: True)
    monkeypatch.setattr(tcal, "_device_key", lambda dev: "cuda:test card")
    real_m, real_s = tcal._measure, tcal._measure_sparse
    monkeypatch.setattr(tcal, "_measure", lambda dev: real_m(CPU))
    monkeypatch.setattr(tcal, "_measure_sparse", lambda dev: real_s(CPU))
    return FakeExecutor("cuda")


def test_off_the_card_a_start_checks_nothing():
    """The JAX package answers off its device with the instant `non-tpu`
    record; the port's start checks nothing off the card."""
    j = jcal.calibrate_count_backend()
    assert (j["backend"], j["source"]) == ("xla", "non-tpu")
    tserver.check_card(FakeExecutor())
    assert tcal.calibration_snapshot() is None


def test_check_at_the_jax_package_s_forced_shapes():
    j = jcal.calibrate_count_backend(force_measure=True)
    t = tcal.check_kernels(CPU)
    assert set(j) == set(t) - {"sparse"} == RECORD_KEYS
    assert j["source"] == t["source"] == "measured"
    assert j["shape"] == t["shape"] == {"slices": 8, "capacity": 32}
    assert j["interpret"] is t["interpret"] is True
    assert t["pallas_ms"] > 0 and t["xla_ms"] > 0
    assert (t["backend"], t["device"]) == ("xla", "cpu")


def test_sparse_check_at_the_jax_package_s_forced_shapes():
    j = jcal.calibrate_sparse_backend(force_measure=True)
    t = tcal.check_kernels(CPU)["sparse"]
    assert set(j) == set(t) == RECORD_KEYS
    assert j["source"] == t["source"] == "measured"
    assert j["shape"] == t["shape"] == {"containers": 16, "values": 128}
    assert t["pallas_ms"] > 0 and t["xla_ms"] > 0


def test_every_check_measures_again():
    """No verdict is kept between checks: a second check runs the
    kernels again and replaces the record."""
    first = tcal.check_kernels(CPU)
    second = tcal.check_kernels(CPU)
    assert second is not first
    assert second["source"] == second["sparse"]["source"] == "measured"
    assert tcal.calibration_snapshot() == second


def test_snapshot_carries_the_sparse_record_as_the_jax_one_does():
    assert tcal.calibration_snapshot() is None
    tcal.check_kernels(CPU)
    snap = tcal.calibration_snapshot()
    jcal.calibrate_count_backend(force_measure=True)
    jcal.calibrate_sparse_backend(force_measure=True)
    jsnap = jcal.calibration_snapshot()
    assert set(snap) == set(jsnap)
    assert set(snap["sparse"]) == set(jsnap["sparse"])
    snap["sparse"]["source"] = "edited"
    assert tcal.calibration_snapshot()["sparse"]["source"] == "measured"


def test_error_raises_where_the_jax_package_answers_xla(monkeypatch):
    def broken_measure(*_a, **_k):
        raise RuntimeError("boom")

    monkeypatch.setattr(jcal, "_measure", broken_measure)
    monkeypatch.setattr(tcal, "_measure", broken_measure)
    j = jcal.calibrate_count_backend(force_measure=True)
    assert (j["backend"], j["source"]) == ("xla", "error")
    assert "boom" in j["error"]
    with pytest.raises(tcal.CalibrationError, match="boom"):
        tcal.check_kernels(CPU)
    rec = tcal.calibration_snapshot()
    assert rec["source"] == "error" and rec["backend"] is None
    assert "boom" in rec["error"] and rec["device"] == "cpu"


def test_planted_mismatch_raises(monkeypatch):
    """A wrong kernel answer: the JAX package answers "xla" with the
    mismatch as its error; the port raises."""
    real_j, real_t = jkernels.coarse_count_uniform, tkernels.coarse_count_uniform
    monkeypatch.setattr(jkernels, "coarse_count_uniform",
                        lambda *a, **k: real_j(*a, **k) + 1)
    monkeypatch.setattr(tkernels, "coarse_count_uniform",
                        lambda *a, **k: real_t(*a, **k) + 1)
    monkeypatch.setenv("PILOSA_TPU_CALIBRATE_SLICES", "4")
    j = jcal.calibrate_count_backend(force_measure=True)
    assert (j["backend"], j["source"]) == ("xla", "error")
    assert "mismatch" in j["error"]
    with pytest.raises(tcal.CalibrationError, match="count check mismatch"):
        tcal.check_kernels(CPU)


def test_planted_sparse_mismatch_raises(monkeypatch):
    real = tkernels.pallas_sparse_pair_counts
    monkeypatch.setattr(tkernels, "pallas_sparse_pair_counts",
                        lambda *a: real(*a) + 1)
    with pytest.raises(tcal.CalibrationError, match="sparse check mismatch"):
        tcal.check_kernels(CPU)
    assert tcal.calibration_snapshot()["source"] == "error"


def test_check_card_checks_a_card_at_every_start(fake_card):
    tserver.check_card(fake_card)
    first = tcal.calibration_snapshot()
    assert first["device"] == first["sparse"]["device"] == "cuda:test card"
    assert first["source"] == first["sparse"]["source"] == "measured"
    tserver.check_card(fake_card)
    assert tcal.calibration_snapshot() is not first


@pytest.mark.parametrize("kind,match", [
    ("canary", "canary failed"), ("error", "ZeroDivisionError"),
    ("mismatch", "count check mismatch"),
    ("sparse_mismatch", "sparse check mismatch")])
def test_check_card_refuses_a_failed_check(fake_card, monkeypatch, kind,
                                           match):
    if kind == "canary":
        monkeypatch.setattr(tkernels, "probe_ok", lambda dev: False)
    elif kind == "error":
        monkeypatch.setattr(tcal, "_measure", lambda dev: 1 / 0)
    elif kind == "mismatch":
        real = tkernels.coarse_count_uniform
        monkeypatch.setattr(tkernels, "coarse_count_uniform",
                            lambda *a, **k: real(*a, **k) + 1)
    else:
        real = tkernels.pallas_sparse_pair_counts
        monkeypatch.setattr(tkernels, "pallas_sparse_pair_counts",
                            lambda *a: real(*a) + 1)
    with pytest.raises(RuntimeError, match=match):
        tserver.check_card(fake_card)
    if kind != "canary":
        assert tcal.calibration_snapshot()["source"] == "error"


def test_the_check_s_launches_are_not_counted():
    """kernels.uncounted: a launch inside it, on its thread, moves no
    counter; one outside it, or on another thread meanwhile, does."""
    before = tkernels.LAUNCHES["probe_ok"]
    other = threading.Thread(target=tkernels._launched, args=("probe_ok", 0))
    with tkernels.uncounted():
        tkernels._launched("probe_ok", 0)
        other.start()
        other.join()
    assert tkernels.LAUNCHES["probe_ok"] == before + 1
    tkernels._launched("probe_ok", 0)
    assert tkernels.LAUNCHES["probe_ok"] == before + 2
    with pytest.raises(RuntimeError, match="CUDA error 7"), \
            tkernels.uncounted():
        tkernels._launched("probe_ok", 7)


def seed_dir(path):
    from pilosa_tpu import SLICE_WIDTH
    from pilosa_tpu.core import Holder as JaxHolder

    h = JaxHolder(str(path))
    h.open()
    f = h.create_index_if_not_exists("i").create_frame_if_not_exists(
        "general")
    for r in (0, 1):
        for c in range(0, 4000, r + 1):
            f.set_bit(r, c)
            f.set_bit(r, SLICE_WIDTH + 3 * c)
    h.close()


def test_debug_vars_carry_the_record_as_the_jax_handler_does(tmp_path):
    from pilosa_tpu.api.handler import Handler as JaxHandler
    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.executor import Executor as JaxExecutor

    seed_dir(tmp_path / "d")
    shutil.copytree(tmp_path / "d", tmp_path / "p")
    jh, th = JaxHolder(str(tmp_path / "d")), Holder(str(tmp_path / "p"))
    jh.open()
    th.open()
    try:
        jhd = JaxHandler(jh, JaxExecutor(jh, use_device=True))
        thd = Handler(th, Executor(th, device="cpu"))
        assert "count_calibration" not in thd.handle(
            "GET", "/debug/vars").json()
        jcal.calibrate_count_backend(force_measure=True)
        jcal.calibrate_sparse_backend(force_measure=True)
        tcal.check_kernels(CPU)
        jv = jhd.handle("GET", "/debug/vars").json()["count_calibration"]
        tv = thd.handle("GET", "/debug/vars").json()["count_calibration"]
    finally:
        jh.close()
        th.close()
    assert set(jv) == set(tv)
    assert set(jv["sparse"]) == set(tv["sparse"])
    assert tv["source"] == tv["sparse"]["source"] == "measured"


def test_a_count_never_checks(tmp_path):
    """The JAX serving layer resolves its calibration at its first Count
    (pilosa_tpu/parallel/serve.py:1730-1780); the port's checks only at a
    start, so Counts, sorted-array ones too, neither check nor fail on a
    check."""
    seed_dir(tmp_path / "d")
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        q = parse_string("Count(Intersect(Bitmap(rowID=0), Bitmap(rowID=1)))")
        n = ex.execute("i", q)[0]
        stats = ex.mesh_manager().stats
        assert stats["count"] == 1 and stats["sparse_count"] == 1
        assert ex.execute("i", q)[0] == n
        assert tcal.calibration_snapshot() is None
    finally:
        h.close()
