"""Shared pieces of the port's tests of admission and observability
(tests/test_torch_{sched,trace,slo,costs,health,admission}.py): the two
packages side by side, a handler of each over a fresh holder on the
CPU, and an autouse fixture that leaves every process-global store of
both packages as it found it.

A test module takes them by importing them:

    from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401

`pkg` is parametrised over PKGS ("jax", then "torch"): each test runs
once against the JAX package and once against the port, so the two are
held to the same expectations.

isolated_stores replaces the state of the cost ledger and its watch,
the health registry and the profile histograms of both packages (the
instances' own attributes, through monkeypatch, so every module that
imported the singleton by name sees the change) and puts it back after
the test: a tenant a test charges never reaches another test's ledger.
"""

from collections import OrderedDict
from types import SimpleNamespace

import pytest

import pilosa_tpu.ctl.main as jax_ctl
import pilosa_tpu.executor as jax_executor
from pilosa_tpu import errors as jax_errors
from pilosa_tpu import fault as jax_fault
from pilosa_tpu import obs as jax_obs
from pilosa_tpu import sched as jax_sched
from pilosa_tpu.obs import costs as jax_costs
from pilosa_tpu.obs import flight as jax_flight
from pilosa_tpu.obs import health as jax_health
from pilosa_tpu.obs import metrics as jax_metrics
from pilosa_tpu.obs import profile as jax_profile
from pilosa_tpu.obs import slo as jax_slo

import pilosa_tpu_torch.ctl.main as port_ctl
import pilosa_tpu_torch.executor as port_executor
from pilosa_tpu_torch import errors as port_errors
from pilosa_tpu_torch import fault as port_fault
from pilosa_tpu_torch import obs as port_obs
from pilosa_tpu_torch import sched as port_sched
from pilosa_tpu_torch.obs import costs as port_costs
from pilosa_tpu_torch.obs import flight as port_flight
from pilosa_tpu_torch.obs import health as port_health
from pilosa_tpu_torch.obs import metrics as port_metrics
from pilosa_tpu_torch.obs import profile as port_profile
from pilosa_tpu_torch.obs import slo as port_slo


def _jax_handler(path):
    from pilosa_tpu.api import Handler
    from pilosa_tpu.core import Holder
    from pilosa_tpu.executor import Executor
    from pilosa_tpu.parallel import new_test_cluster

    holder = Holder(str(path))
    holder.open()
    cluster = new_test_cluster(1)
    ex = Executor(holder, host=cluster.nodes[0].host, cluster=cluster,
                  use_device=False)
    return holder, Handler(holder, ex, cluster=cluster,
                           host=cluster.nodes[0].host)


def _port_handler(path):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.server import build_handler

    holder = Holder(str(path))
    holder.open()
    return holder, build_handler(holder, "cpu", 0.0)


PKGS = {
    "jax": SimpleNamespace(
        name="jax", obs=jax_obs, sched=jax_sched, errors=jax_errors,
        fault=jax_fault, costs=jax_costs, flight=jax_flight,
        health=jax_health, metrics=jax_metrics, profile=jax_profile,
        slo=jax_slo, ctl=jax_ctl, executor=jax_executor,
        make_handler=_jax_handler),
    "torch": SimpleNamespace(
        name="torch", obs=port_obs, sched=port_sched, errors=port_errors,
        fault=port_fault, costs=port_costs, flight=port_flight,
        health=port_health, metrics=port_metrics, profile=port_profile,
        slo=port_slo, ctl=port_ctl, executor=port_executor,
        make_handler=_port_handler),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    p = PKGS[request.param]
    yield p
    p.fault.reset()


def _fresh_ledger(monkeypatch, led):
    for attr, val in (("_accounts", OrderedDict()), ("_shape_dev", {}),
                      ("_tenant_dev", {}), ("_total_dev", 0.0),
                      ("_dev_samples", 0), ("_views", {}),
                      ("events", {"tracked": 0, "folded": 0,
                                  "unattributed": 0}),
                      ("enabled", True), ("max_accounts", 256)):
        monkeypatch.setattr(led, attr, val)


def _fresh_watch(monkeypatch, watch):
    for attr, val in (("_bands", OrderedDict()), ("enabled", True),
                      ("max_bands", 256), ("k", 4.0), ("min_n", 32)):
        monkeypatch.setattr(watch, attr, val)


def _fresh_health(monkeypatch, reg, stat_map):
    for attr, val in (("enabled", True), ("stall_after", 4.0),
                      ("sweep_interval", 1.0), ("dossier_dir", None),
                      ("dossier_max_bytes", 256 << 10),
                      ("dossier_keep", 8), ("bundle_providers", {}),
                      ("_beats", {}), ("_inflight", {}), ("_critical", set()),
                      ("_state", {}), ("_stalled_since", {}),
                      ("_stall_info", {}), ("_trips", stat_map()),
                      ("_dossier_written", set()), ("_dossier_seq", 0),
                      ("_peers", {}), ("_last_sweep", 0.0), ("_sweeps", 0)):
        monkeypatch.setattr(reg, attr, val)


@pytest.fixture(autouse=True)
def isolated_stores(monkeypatch):
    watchdogs = {}
    for name, p in PKGS.items():
        _fresh_ledger(monkeypatch, p.costs.LEDGER)
        _fresh_watch(monkeypatch, p.costs.WATCH)
        _fresh_health(monkeypatch, p.health.HEALTH, p.metrics.StatMap)
        watchdogs[name] = (p.health.HEALTH._thread, p.health.HEALTH._refs)
        monkeypatch.setattr(p.profile.STATS, "_phase", {})
        monkeypatch.setattr(p.profile.STATS, "_roofline", {})
    yield
    for name, p in PKGS.items():
        reg = p.health.HEALTH
        thread, refs = watchdogs[name]
        if reg._thread is not None and reg._thread is not thread:
            reg._refs = 1  # a watchdog the test started and left
            reg.stop()
        reg._refs = refs
        p.fault.reset()
