"""The port's Config against the JAX package's, on the same inputs: the
JAX module docstring's full schema, seeded configs over every key,
`Config().to_toml()`, the vestigial [plugins] section, and the bad
values that raise. Every attribute the two share is equal and
`to_toml` gives the same text (tolerance 0: the values are parsed, not
computed). The port's departures (use-device, count-backend, the
cluster refusal, the env overrides) each have a test of their own.
"""

import os
import subprocess
import sys
import textwrap
import tomllib

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import pilosa_tpu.config as jax_config
from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu.config import parse_duration as jax_parse_duration

from pilosa_tpu_torch import config as port_config
from pilosa_tpu_torch.config import Config, parse_duration
from pilosa_tpu_torch.server import Server, refuse_cluster
from torch_threads import one_torch_thread  # noqa: F401


def docstring_schema() -> str:
    """The TOML of the JAX config's module docstring, every line of it
    (the commented-out [[schema.indexes]] block uncommented)."""
    doc = jax_config.__doc__
    body = doc[doc.index("TOML schema:") + len("TOML schema:"):
               doc.index("Defaults match the reference")]
    lines = []
    for line in textwrap.dedent(body).splitlines():
        if line.startswith("# [[schema") or line.startswith("# name =") \
                or line.startswith("# column-label") \
                or line.startswith("# row-label") \
                or line.startswith("# min") or line.startswith("# max"):
            line = line[2:]
        lines.append(line)
    return "\n".join(lines)


def assert_same(port: Config, jax: JaxConfig):
    assert set(vars(jax)) <= set(vars(port))
    assert {k: getattr(port, k) for k in vars(jax)} == vars(jax)
    assert port.to_toml() == jax.to_toml()


def test_docstring_schema_loads_the_same():
    text = docstring_schema()
    assert "[[schema.indexes.frames.fields]]" in text
    port = Config.from_toml(text, is_text=True)
    jax = JaxConfig.from_toml(text, is_text=True)
    assert_same(port, jax)
    assert port.schema_indexes == [{"name": "i", "column-label": "columnID",
                                    "frames": [{"name": "f",
                                                "row-label": "rowID",
                                                "fields": [jax.schema_indexes[
                                                    0]["frames"][0][
                                                    "fields"][0]]}]}]
    # to_toml's text parses back to the same config, in both packages.
    again = Config.from_toml(port.to_toml(), is_text=True)
    assert_same(again, JaxConfig.from_toml(jax.to_toml(), is_text=True))


def test_default_config_text_is_the_jax_text():
    assert Config().to_toml() == JaxConfig().to_toml()
    assert_same(Config(), JaxConfig())
    tomllib.loads(Config().to_toml())


def test_reference_plugins_section_loads_unchanged():
    text = ('data-dir = "/tmp/p"\n[plugins]\npath = "/opt/plugins"\n'
            '[cluster]\nreplicas = 3\n')
    port, jax = Config.from_toml(text, True), JaxConfig.from_toml(text, True)
    assert_same(port, jax)
    assert port.plugins_path == "/opt/plugins" and port.replica_n == 3
    assert Config().plugins_path == ""


def test_from_file(tmp_path):
    p = tmp_path / "node.toml"
    p.write_text(docstring_schema())
    assert_same(Config.from_toml(str(p)), JaxConfig.from_toml(str(p)))


# -- seeded configs over every key ---------------------------------------------------

dur = st.one_of(
    st.builds(lambda n, u: f"{n}{u}", st.integers(0, 5000),
              st.sampled_from(["ns", "us", "µs", "ms", "s", "m", "h"])),
    st.builds(lambda a, b: f"{a}m{b}s", st.integers(0, 90),
              st.integers(0, 59)),
    st.integers(0, 10_000))
small = st.integers(-1, 100_000)
frac = st.floats(0, 1, allow_nan=False).map(lambda f: round(f, 6))
flag = st.booleans()
word = st.text("abcdefghij_", min_size=1, max_size=6)
hostname = st.builds(lambda h, p: f"{h}:{p}", word, st.integers(1, 65535))

SECTIONS = {
    "": {"data-dir": word, "host": hostname, "log-path": word,
         "use-device": st.sampled_from(["auto", "on", "off"])},
    "cluster": {
        "replicas": small, "partitions": small,
        "hosts": st.lists(hostname, max_size=3),
        "type": st.sampled_from(["http", "static", "gossip", "spmd"]),
        "gossip-port": small, "gossip-seed": word,
        "spmd-coordinator": word, "spmd-processes": small,
        "spmd-process-id": small, "polling-interval": dur,
        "client-timeout": dur, "query-deadline": dur, "retries": small,
        "retry-backoff": dur, "breaker-threshold": small,
        "breaker-cooldown": dur, "prefer-local-reads": flag,
        "ici-hosts": st.lists(hostname, max_size=2),
        "write-consistency": st.sampled_from(["one", "quorum", "all"]),
        "hint-max-bytes": small, "hint-drain-interval": dur,
        "default-read-staleness": dur, "result-cache-size": small},
    "anti-entropy": {"interval": dur,
                     "jitter": st.one_of(dur, st.just("-1s")),
                     "block-deadline": dur},
    "rebalance": {"concurrency": small, "retries": small,
                  "retry-backoff": dur},
    "plugins": {"path": word},
    "obs": {"slow-query-threshold": dur, "trace-ring": small,
            "metrics-sample-interval": dur, "profile-sample-rate": small,
            "fleet-scrape-interval": dur, "queryshape-ring": small,
            "cost-ledger": flag, "cost-max-accounts": small,
            "cost-watch-bands": small, "cost-regression-k": frac,
            "cost-regression-min-n": small, "cost-debt-threshold": frac},
    "log": {"level": st.sampled_from(["debug", "info", "warning", "error"]),
            "format": st.sampled_from(["text", "json"]), "path": word},
    "sched": {"enabled": flag, "max-window-us": small,
              "idle-window-us": small, "queue-depth": small,
              "default-service-us": small,
              "tenant-weights": st.dictionaries(word, frac, max_size=3)},
    "mesh": {"hbm-budget-bytes": small, "hbm-headroom-fraction": frac,
             "quarantine-after": small, "quarantine-ttl": dur,
             "sparse-density-threshold": frac, "stage-chunk-mb": small,
             "count-backend": st.sampled_from(["auto", "pallas"])},
    "storage": {"fsync-policy": st.sampled_from(["never", "group",
                                                 "always"]),
                "group-commit-window-us": small, "max-wal-ops": small,
                "backpressure-deadline": dur, "max-op-n": small},
    "integrity": {"enabled": flag, "scrub-interval": dur,
                  "scrub-rate-limit-bytes": small,
                  "shadow-sample-1-in": small,
                  "result-cache-verify-1-in": small},
    "slo": {"enabled": flag, "availability": frac, "p99-us": small,
            "latency-target": frac, "shed-rate-max": frac},
    "health": {"enabled": flag, "sweep-interval": dur, "stall-after": frac,
               "dossier-max": small, "dossier-keep": small},
}

field_def = st.builds(
    lambda name, lo, span: {"name": name, "min": lo, "max": lo + span},
    st.sampled_from(["v", "w", "x"]), st.integers(-10**6, 10**6),
    st.integers(0, 10**6))
schema = st.lists(st.fixed_dictionaries(
    {"name": word},
    optional={"column-label": word,
              "frames": st.lists(st.fixed_dictionaries(
                  {"name": word},
                  optional={"row-label": word,
                            "fields": st.lists(field_def, max_size=2,
                                               unique_by=lambda d: d["name"])}),
                  max_size=2)}), max_size=2)


@st.composite
def config_dicts(draw):
    out = {}
    for section, keys in SECTIONS.items():
        chosen = draw(st.lists(st.sampled_from(sorted(keys)), unique=True))
        values = {k: draw(keys[k]) for k in chosen}
        if section:
            out[section] = values
        else:
            out.update(values)
    if draw(st.booleans()):
        out["schema"] = {"indexes": draw(schema)}
    return out


@settings(max_examples=150, deadline=None, derandomize=True)
@given(data=config_dicts())
def test_seeded_configs_over_every_key(data):
    assert_same(Config.from_dict(data), JaxConfig.from_dict(data))


def test_every_key_of_the_jax_printer_is_read():
    """Every key `to_toml` prints, over every section, is one the
    strategies above draw: a key the JAX schema gains fails here."""
    doc = tomllib.loads(JaxConfig().to_toml())
    for section, keys in doc.items():
        if isinstance(keys, dict):
            assert set(keys) <= set(SECTIONS[section]), section
        else:
            assert section in SECTIONS[""], section


@pytest.mark.parametrize("value", [
    "10m", "1h30m", "250ms", "50us", "50µs", "100ns", "2h", "1m1s",
    "0s", "", 5, 2.5])
def test_parse_duration_is_the_jax_one(value):
    assert parse_duration(value) == jax_parse_duration(value)


@pytest.mark.parametrize("value", ["5x", "1m5", "ms", "-"])
def test_parse_duration_raises_as_jax(value):
    with pytest.raises(ValueError):
        jax_parse_duration(value)
    with pytest.raises(ValueError):
        parse_duration(value)


def test_fault_uses_the_one_parse_duration():
    from pilosa_tpu_torch import fault

    assert fault.parse_duration is port_config.parse_duration
    assert parse_duration("0") == 0.0 and parse_duration("1.5") == 1.5


# -- bad values raise in both ----------------------------------------------------------

BAD = {
    "fsync-policy": ('[storage]\nfsync-policy = "fsynk"\n',
                     lambda c: c.wal_config()),
    "use-device": ('use-device = "onn"\n', lambda c: c.use_device_flag()),
    "write-consistency": ('[cluster]\nwrite-consistency = "qourum"\n',
                          None),
    "duration": ('[anti-entropy]\ninterval = "10x"\n', None),
    "field range": ('[[schema.indexes]]\nname = "i"\n'
                    '[[schema.indexes.frames]]\nname = "f"\n'
                    '[[schema.indexes.frames.fields]]\nname = "v"\n'
                    'min = 10\nmax = 1\n', None),
    "unnamed index": ('[[schema.indexes]]\ncolumn-label = "c"\n', None),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_values_raise_in_both(case):
    text, use = BAD[case]
    for cls in (JaxConfig, Config):
        with pytest.raises(ValueError):
            cfg = cls.from_toml(text, is_text=True)
            if use is not None:
                use(cfg)


def redefined_field_config(cls, path, hi):
    cfg = cls.from_toml(
        f'data-dir = "{path}"\nhost = "127.0.0.1:0"\nuse-device = "off"\n'
        '[[schema.indexes]]\nname = "i"\n[[schema.indexes.frames]]\n'
        'name = "f"\n[[schema.indexes.frames.fields]]\nname = "v"\n'
        f'min = 0\nmax = {hi}\n', is_text=True)
    cfg.anti_entropy_interval = cfg.polling_interval = 3600
    return cfg


def test_a_schema_that_redefines_a_field_fails_open_in_both(tmp_path):
    from pilosa_tpu.server import Server as JaxServer

    for name, cls, srv_cls in (("jax", JaxConfig, JaxServer),
                               ("port", Config, Server)):
        path = str(tmp_path / name)
        srv = srv_cls(redefined_field_config(cls, path, 100))
        srv.open(port=0)
        srv.close()
        srv = srv_cls(redefined_field_config(cls, path, 200))
        with pytest.raises(Exception) as err:
            srv.open(port=0)
        assert "v" in str(err.value)
        srv.close()


# -- the port's departures -------------------------------------------------------------


@pytest.mark.parametrize("value,device", [
    ("auto", "cuda"), ("on", "cuda"), ("", "cuda"), ("true", "cuda"),
    ("off", "cpu"), ("false", "cpu"), ("0", "cpu")])
def test_use_device_auto_means_the_card(value, device):
    cfg = Config.from_toml(f'use-device = "{value}"\n', is_text=True)
    assert cfg.use_device_flag() == JaxConfig.from_toml(
        f'use-device = "{value}"\n', is_text=True).use_device_flag()
    assert cfg.device() == device


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="the refusal needs a machine without a card")
def test_use_device_auto_without_a_card_refuses_to_start(tmp_path):
    cfg = Config.from_toml(f'data-dir = "{tmp_path}"\n', is_text=True)
    assert cfg.use_device == "auto"
    with pytest.raises(RuntimeError, match="cuda"):
        Server(cfg)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret", "mosaic"])
def test_count_backend_without_a_card_kernel_raises(backend):
    text = f'[mesh]\ncount-backend = "{backend}"\n'
    if backend != "mosaic":
        assert JaxConfig.from_toml(text, True).mesh_count_backend == backend
    with pytest.raises(ValueError, match="count-backend"):
        Config.from_toml(text, is_text=True)


@pytest.mark.parametrize("backend", ["auto", "pallas", "PALLAS"])
def test_count_backend_auto_and_pallas_are_the_kernels(backend):
    cfg = Config.from_toml(f'[mesh]\ncount-backend = "{backend}"\n', True)
    assert cfg.mesh_count_backend == backend.lower()


CLUSTERS = {
    "hosts": '[cluster]\nhosts = ["a:1", "b:2"]\n',
    "type = \"gossip\"": '[cluster]\ntype = "gossip"\n',
    "type = \"spmd\"": '[cluster]\ntype = "spmd"\n',
    "ici-hosts": '[cluster]\nici-hosts = ["c:3"]\n',
}


@pytest.mark.parametrize("key", sorted(CLUSTERS))
def test_a_config_that_needs_a_cluster_is_refused(key, tmp_path):
    text = f'data-dir = "{tmp_path}"\nuse-device = "off"\n' + CLUSTERS[key]
    cfg = Config.from_toml(text, is_text=True)
    assert_same(cfg, JaxConfig.from_toml(text, is_text=True))
    with pytest.raises(ValueError) as err:
        Server(cfg)
    assert key in str(err.value) and "A11" in str(err.value)
    assert not os.path.exists(tmp_path / "i")


def test_one_node_cluster_sections_are_served(tmp_path):
    for ctype in ("http", "static"):
        refuse_cluster(Config.from_toml(
            f'[cluster]\ntype = "{ctype}"\nhosts = ["x:1"]\n', True))
    with pytest.raises(ValueError, match="unknown cluster type"):
        refuse_cluster(Config.from_toml('[cluster]\ntype = "udp"\n', True))


def test_mesh_config_is_the_executor_dict():
    from pilosa_tpu_torch.parallel.serve import MESH_DEFAULTS, mesh_config

    cfg = Config.from_toml('[mesh]\nhbm-budget-bytes = 123\n'
                           'hbm-headroom-fraction = 0.25\n'
                           'quarantine-after = 7\nquarantine-ttl = "2m"\n',
                           is_text=True)
    assert mesh_config(cfg.mesh_config()) == {
        "hbm_budget_bytes": 123, "hbm_headroom": 0.25,
        "quarantine_after": 7, "quarantine_ttl": 120.0}
    assert mesh_config(Config().mesh_config()) == MESH_DEFAULTS


def test_wal_config_carries_the_storage_section():
    cfg = Config.from_toml('[storage]\nfsync-policy = "always"\n'
                           'group-commit-window-us = 900\n'
                           'max-wal-ops = 10\nbackpressure-deadline = "2s"\n'
                           'max-op-n = 0\n', is_text=True)
    w = cfg.wal_config()
    assert (w.fsync_policy, w.group_window_us, w.max_wal_ops,
            w.backpressure_deadline, w.max_op_n) == ("always", 900.0, 10,
                                                      2.0, None)
    j = JaxConfig.from_toml(cfg.to_toml(), True).wal_config()
    assert (j.fsync_policy, j.group_window_us, j.max_wal_ops,
            j.backpressure_deadline) == (w.fsync_policy, w.group_window_us,
                                         w.max_wal_ops,
                                         w.backpressure_deadline)


def test_stage_chunk_mb_is_an_env_default(monkeypatch):
    from pilosa_tpu_torch.parallel import mesh

    monkeypatch.delenv(port_config.STAGE_CHUNK_ENV, raising=False)
    assert mesh._stage_chunk_bytes() == 64 << 20
    Config.from_toml('[mesh]\nstage-chunk-mb = 3\n', True).apply_mesh_env()
    assert mesh._stage_chunk_bytes() == 3 << 20
    # An exported value wins over the config.
    monkeypatch.setenv(port_config.STAGE_CHUNK_ENV, "5")
    Config.from_toml('[mesh]\nstage-chunk-mb = 3\n', True).apply_mesh_env()
    assert mesh._stage_chunk_bytes() == 5 << 20


def test_sparse_threshold_env_wins(monkeypatch):
    cfg = Config.from_toml('[mesh]\nsparse-density-threshold = 0.2\n', True)
    monkeypatch.delenv(port_config.THRESHOLD_ENV, raising=False)
    assert cfg.sparse_density_threshold() == 0.2
    monkeypatch.setenv(port_config.THRESHOLD_ENV, "0")
    assert cfg.sparse_density_threshold() == 0.0


def test_config_imports_no_torch():
    code = ("import sys; import pilosa_tpu_torch.config as c; "
            "c.Config.from_toml(c.Config().to_toml(), True); "
            "assert 'torch' not in sys.modules, 'torch imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
