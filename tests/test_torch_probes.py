"""The port's on-chip probe tools (pilosa_tpu_torch/tools) and their
kernels against the JAX tools under tools/.

K6 coarse_count_blocked's plain version is held exactly against the JAX
bandwidth probe's own Pallas kernel (tools/probe_r5_bw.py
coarse_count_uniform, interpret mode), stream_popcount's against the XLA
whole-pool popcount both JAX tools take as their ceiling, and K0 on the
compile probe's input against that probe's x + 1 Pallas body
(tools/probe_r5.py:207-212). Each tool's main runs on the CPU at a small
size and writes its record under --out, never to the repo root.
"""

import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.tools import (probe_r5, probe_r5_bw, profile_headline,
                                    profile_stage)
from tools.probe_r5_bw import coarse_count_uniform as jax_blocked
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
S, CAP = 8, 32
L0, L1, L2 = (["leaf", i] for i in range(3))
# name -> (tree, run index per leaf; negative = absent)
CASES = {
    "and": (["and", L0, L1], [0, 1]),
    "or": (["or", L0, L1], [1, 0]),
    "andnot": (["andnot", L0, L1], [0, 1]),
    "three_leaves": (["andnot", ["or", L0, L1], L2], [1, 0, 1]),
    "absent_leaf": (["or", L0, L1], [0, -1]),
}


def pools(n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 1 << 32, size=(S, CAP, 2048), dtype=np.uint32)
           for _ in range(n)]
    out[0][1, :16] = 0xFFFFFFFF  # a full run
    out[-1][2] = 0               # an empty slice
    return out


@pytest.mark.parametrize("t", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_plain_matches_the_jax_probe_kernel(case, t):
    tree, starts = CASES[case]
    words = pools(len(starts), seed=len(case) + t)
    want = np.asarray(jax_blocked(
        tuple(jnp.asarray(w) for w in words),
        jnp.asarray(np.array(starts, dtype=np.int32)), tree, t,
        interpret=True))
    got = tk.coarse_count_blocked(
        tuple(torch.from_numpy(w.view(np.int32)) for w in words),
        torch.tensor(starts, dtype=torch.int32), tree, t)
    assert got.dtype == torch.int32 and got.shape == (1, S)
    assert np.array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_blocked_rejects_what_the_kernel_does_not_take():
    p = torch.zeros((S, CAP, 2048), dtype=torch.int32)
    starts = torch.tensor([0, 1], dtype=torch.int32)
    for t in (3, 16, 64):  # not a block size, or not dividing S = 8
        with pytest.raises(ValueError, match="T="):
            tk.coarse_count_blocked((p, p), starts, CASES["and"][0], t)
    with pytest.raises(ValueError, match="starts"):
        tk.coarse_count_blocked((p, p), starts[:1], CASES["and"][0], 1)


@pytest.mark.parametrize("kind", ["random", "all_ones", "odd_length"])
def test_stream_plain_matches_the_xla_popcount(kind):
    rng = np.random.default_rng(5)
    if kind == "all_ones":
        words = np.full((S, CAP, 2048), 0xFFFFFFFF, dtype=np.uint32)
    elif kind == "odd_length":
        words = rng.integers(0, 1 << 32, size=4097, dtype=np.uint32)
    else:
        words = rng.integers(0, 1 << 32, size=(S, CAP, 2048),
                             dtype=np.uint32)
    want = int(jnp.sum(lax.population_count(jnp.asarray(words)).astype(
        jnp.int32)))
    got = tk.stream_popcount(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    if kind == "all_ones":
        assert want == words.size * 32


def test_stream_rejects_other_dtypes():
    with pytest.raises(ValueError, match="int32"):
        tk.stream_popcount(torch.zeros(8, dtype=torch.int64))


def test_probe_add_matches_the_compile_probe_kernel():
    def kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] + 1

    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        interpret=True)(jnp.asarray(x)))
    got = tk.probe_add(torch.from_numpy(x.copy()))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, x + 1)


def root_records() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for pat in ("PROBE_R5_*.json", "PROFILE_*.json")
            for p in sorted(REPO.glob(pat))}


# tool -> (module, argv before the common flags, record, its keys)
TOOLS = {
    "probe_r5_bw": (probe_r5_bw, [], "probe_r5_bw",
                    {"s8_per_slice", "s8_blocked_t1", "s8_blocked_t4",
                     "s8_blocked_t8", "s8_plain_static", "s8_stream",
                     "s8_torch_sum_read"}),
    "probe_r5 stage": (probe_r5, ["stage"], "probe_r5_stage",
                       {"pageable_cold", "pageable", "pinned", "chunks4",
                        "chunks16", "staged_from_numpy"}),
    "probe_r5 readback": (probe_r5, ["readback"], "probe_r5_readback",
                          {"same_thread", "sync_then_fetch", "fresh_thread",
                           "fetch_thread", "pipelined", "event_poll"}),
    "probe_r5 kernels": (probe_r5, ["kernels"], "probe_r5_kernels",
                         {"build_s", "probe_first_s", "probe_correct",
                          "coarse_first_s", "coarse_correct"}),
    "profile_stage": (profile_stage, [], "profile_stage",
                      {"stage", "pack", "uploads"}),
    "profile_headline": (profile_headline, [], "profile_headline",
                         {"components", "adds_ms"}),
}
# Where each record keeps the keys above (None: at its top level).
SECTION = {"probe_r5_bw": "rows", "probe_r5_stage": "uploads",
           "probe_r5_readback": "variants"}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu_and_writes_its_record(tool, tmp_path):
    import json

    mod, argv, name, keys = TOOLS[tool]
    before = root_records()
    assert before, "the JAX tools' TPU records are in the repo root"
    rc = mod.main(argv + ["--device", "cpu", "--slices", "8", "--reps", "2",
                          "--out", str(tmp_path)])
    assert rc == 0
    assert [p.name for p in tmp_path.iterdir()] == [f"{name}.json"]
    doc = json.loads((tmp_path / f"{name}.json").read_text())
    assert doc["device"] == "cpu" and doc["clock"] == "host"
    assert keys <= set(doc[SECTION[name]] if name in SECTION else doc)
    if name == "profile_headline":
        assert set(doc["components"]) == {
            "noop", "stream", "kernel", "batch16", "manager", "executor",
            "http"}
    assert root_records() == before


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_defaults_to_the_card_and_raises_without_one(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod, argv, _, _ = TOOLS[tool]
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv + ["--slices", "8", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
