"""Loadgen's cluster mode (pilosa_tpu_torch/tools/loadgen.py:
start_inprocess_cluster, run_replica_churn, _judge_write_churn,
_judge_follower_reads) against the JAX tool's, on the CPU.

Both tools boot three in-process nodes of their own package (the port's
with PILOSA_TORCH_USE_DEVICE=off, the JAX tool's at its default, off)
and send the same seeded schedule (the same --print-schedule bytes with
the cluster flags), open loop for 3 s, so the churn meets traffic:

- replicas 3, the last node closed at 0.3 of the run and reopened at
  0.6: both verdicts OK with the same write_churn keys, the replica
  converged (slice 0's block digests) and the hints drained to 0;
- replicas 2, the same churn: quorum needs both copies, so both tools
  see the writes to the closed node's slices refused with 503 and judge
  availability VIOLATED, every other objective OK, the replica
  converged (observed in the reference, ROADMAP C);
- replicas 2 with --staleness-ms 100 and no churn: both verdicts OK,
  the follower-read judge's keys equal, no stale result-cache serve,
  the same schedule ceiling and read count.

Latencies are not judged (--p99-us far above any CPU run). A leg in
flight at the node being closed can fail its query with 400 {"error":
"index not found"} in both packages (the closed holder has no index;
the JAX package every time its leg outlives the close, ROADMAP C), and
the tools count a 4xx as the client's (`client_error`, not against
availability). The churn runs record each 4xx body the tool received,
and tolerate `client_error` only when every one of them is that answer.
"""

import io
import json
import os
import sys
import tempfile
import urllib.error
import urllib.request

import pytest

from pilosa_tpu_torch.tools import loadgen as port_lg
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import loadgen as jax_lg  # noqa: E402

RUN = ["--cluster-nodes", "3", "--mode", "open", "--qps", "40",
       "--duration", "3", "--seed", "3", "--p99-us", "600000000"]
CHURN = ["--kill-replica-at", "0.3", "--restart-replica-at", "0.6",
         "--hint-backlog-max", "0"]


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("PILOSA_TORCH_USE_DEVICE", "off")
    monkeypatch.delenv("PILOSA_TPU_USE_DEVICE", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


CLOSED_LEG = b'{"error": "index not found"}\n'


def tool_4xx(monkeypatch) -> list:
    """The (status, body) of every 4xx but 429 that a loadgen request
    (it carries X-Pilosa-Tenant) gets back; other requests, the nodes'
    own among them, pass untouched."""
    seen = []
    urlopen = urllib.request.urlopen

    def spy(req, *a, **kw):
        try:
            return urlopen(req, *a, **kw)
        except urllib.error.HTTPError as e:
            tool = isinstance(req, urllib.request.Request) and \
                req.get_header("X-pilosa-tenant")
            if not tool or not 400 <= e.code < 500 or e.code == 429:
                raise
            body = e.read()
            seen.append((e.code, body))
            raise urllib.error.HTTPError(e.url, e.code, e.msg, e.hdrs,
                                         io.BytesIO(body)) from None

    monkeypatch.setattr(urllib.request, "urlopen", spy)
    return seen


def both(tmp_path, argv, monkeypatch) -> dict:
    """{package: (rc, report, the tool's 4xx)}."""
    out = {}
    for name, mod in (("port", port_lg), ("jax", jax_lg)):
        path = tmp_path / f"{name}.json"
        with monkeypatch.context() as m:
            seen = tool_4xx(m)
            rc = mod.main([*argv, "--report", str(path), "--quiet"])
        out[name] = (rc, json.loads(path.read_text()), seen)
    return out


def client_errors_are_closed_legs(rep, seen) -> bool:
    return rep["outcomes"].get("client_error", 0) == len(seen) and all(
        st == 400 and body == CLOSED_LEG for st, body in seen)


def verdicts(rep) -> dict:
    return {k: v["verdict"] for k, v in rep["objectives"].items()}


def test_schedule_with_the_cluster_flags_is_byte_identical(capsys):
    argv = ["--print-schedule", *RUN, "--cluster-replicas", "2", *CHURN,
            "--staleness-ms", "100", "--partial"]
    outs = []
    for mod in (port_lg, jax_lg):
        assert mod.main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] and outs[0] == outs[1]


def test_churn_at_replicas_3_converges_in_both(cpu, monkeypatch):
    runs = both(cpu, [*RUN, "--cluster-replicas", "3", *CHURN], monkeypatch)
    for name, (rc, rep, seen) in runs.items():
        assert rc == 0 and rep["verdict"] == "OK", (name, verdicts(rep))
        wc = rep["write_churn"]
        assert wc["killed"] and wc["restarted"], name
        assert wc["replica_converged"] is True, name
        assert wc["hint_backlog_after_drain"] == 0, name
        assert rep["mismatch_growth"] == 0, name
        assert set(rep["outcomes"]) <= {"ok", "client_error"}, name
        assert client_errors_are_closed_legs(rep, seen), (name, seen)
    port, jax = runs["port"][1], runs["jax"][1]
    assert set(port["write_churn"]) == set(jax["write_churn"])
    assert verdicts(port) == verdicts(jax)
    for k in ("requests_total", "read_total", "total_by_decile", "spec"):
        assert port[k] == jax[k], k


def test_churn_at_replicas_2_refuses_the_writes_in_both(cpu, monkeypatch):
    runs = both(cpu, [*RUN, "--cluster-replicas", "2", *CHURN], monkeypatch)
    for name, (rc, rep, seen) in runs.items():
        v = verdicts(rep)
        assert rc == 1 and rep["verdict"] == "VIOLATED", name
        assert v.pop("availability") == "VIOLATED", name
        assert set(v.values()) == {"OK"}, (name, v)
        assert set(rep["outcomes"]) - {"client_error"} == {
            "ok", "backpressure"}, name
        assert client_errors_are_closed_legs(rep, seen), (name, seen)
        assert rep["read_5xx"] == 0, name
        assert rep["write_churn"]["replica_converged"] is True, name
        assert rep["mismatch_growth"] == 0, name
    assert set(runs["port"][1]["write_churn"]) == \
        set(runs["jax"][1]["write_churn"])


def test_bounded_reads_are_judged_in_both(cpu, monkeypatch):
    runs = both(cpu, [*RUN, "--cluster-replicas", "2", "--staleness-ms",
                      "100"], monkeypatch)
    for name, (rc, rep, seen) in runs.items():
        assert seen == [], name
        assert rc == 0 and rep["verdict"] == "OK", (name, verdicts(rep))
        fr = rep["follower_reads"]
        assert fr["read_5xx"] == 0 and fr["stale_cache_serves"] == 0, name
        assert fr["cache_hits"] + fr["cache_misses"] > 0, name
        assert rep["write_churn"]["killed"] is False, name
    port, jax = runs["port"][1], runs["jax"][1]
    assert set(port["follower_reads"]) == set(jax["follower_reads"])
    assert verdicts(port) == verdicts(jax)
    for k in ("staleness_ms", "read_total", "zipf_hit_ceiling"):
        assert port["follower_reads"][k] == jax["follower_reads"][k], k
