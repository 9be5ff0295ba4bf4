"""The node as an operator runs it, against the JAX package's: the ctl's
`server` (build_config's precedence, --dry-run, a child process from a
TOML config with a declared schema, JSON logs and SIGTERM), `bench`,
`check`, `inspect`, `sort` and `config` on the same inputs as the JAX
ctl, and `Server` (the declared schema applied twice, warm, the cache
flush). Answers are exact (tolerance 0: bits and counts are integers).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu.ctl import main as jax_ctl
from pilosa_tpu.server import Server as JaxServer

from pilosa_tpu_torch.api.client import InternalClient
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.ctl import main as port_ctl
from pilosa_tpu_torch.server import Server
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ctl(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


# -- the parser, config, build_config and --dry-run -------------------------------------


def test_parser_covers_every_subcommand():
    ap = port_ctl.make_parser()
    for cmd in ["server", "import", "export", "backup", "restore", "bench",
                "check", "inspect", "sort", "config", "top", "costs",
                "health", "diagnose"]:
        with pytest.raises(SystemExit) as e:
            ap.parse_args([cmd, "--help"])
        assert e.value.code == 0
    with pytest.raises(SystemExit):
        ap.parse_args(["fleet"])  # not ported: no stub


def test_config_command_prints_the_jax_text(capsys):
    port = run_ctl(port_ctl, ["config"], capsys)
    assert port == run_ctl(jax_ctl, ["config"], capsys)
    assert port[0] == 0
    assert Config.from_toml(port[1], is_text=True).host == Config().host


@pytest.fixture
def clean_env(monkeypatch):
    for pre in ("PILOSA_TORCH_", "PILOSA_TPU_"):
        for name in ("HOST", "DATA_DIR", "USE_DEVICE"):
            monkeypatch.delenv(pre + name, raising=False)
    return monkeypatch


def test_build_config_precedence(tmp_path, clean_env):
    toml = tmp_path / "c.toml"
    toml.write_text('host = "from-toml:1"\ndata-dir = "/toml-dir"\n'
                    'use-device = "on"\n')
    ap = port_ctl.make_parser()

    def cfg(*argv):
        return port_ctl.build_config(ap.parse_args(["server", *argv]))

    c = cfg("-c", str(toml))
    assert (c.host, c.data_dir, c.use_device) == ("from-toml:1",
                                                  "/toml-dir", "on")
    clean_env.setenv("PILOSA_TORCH_HOST", "from-env:2")
    clean_env.setenv("PILOSA_TORCH_DATA_DIR", "/env-dir")
    clean_env.setenv("PILOSA_TORCH_USE_DEVICE", "off")
    c = cfg("-c", str(toml))
    assert (c.host, c.data_dir, c.use_device) == ("from-env:2", "/env-dir",
                                                  "off")
    c = cfg("-c", str(toml), "-b", "from-flag:3", "-d", "/flag-dir",
            "--use-device", "auto")
    assert (c.host, c.data_dir, c.use_device) == ("from-flag:3",
                                                  "/flag-dir", "auto")
    # The JAX ctl resolves the same flags the same way (its own env).
    jc = jax_ctl.build_config(jax_ctl.make_parser().parse_args(
        ["server", "-c", str(toml), "-b", "from-flag:3", "-d", "/flag-dir",
         "--use-device", "auto"]))
    assert jc.to_toml() == c.to_toml()


def test_dry_run_precedence(tmp_path, capsys, clean_env):
    cfg = tmp_path / "c.toml"
    cfg.write_text('data-dir = "/from/toml"\nhost = "toml:1"\n')
    clean_env.setenv("PILOSA_TORCH_HOST", "env:2")
    rc, out = run_ctl(port_ctl, ["server", "-c", str(cfg), "-b", "flag:3",
                                 "--dry-run"], capsys)
    assert rc == 0
    assert 'host = "flag:3"' in out and "/from/toml" in out
    clean_env.setenv("PILOSA_TPU_HOST", "env:2")
    assert (rc, out) == run_ctl(jax_ctl, ["server", "-c", str(cfg), "-b",
                                          "flag:3", "--dry-run"], capsys)


def test_dry_run_env_only(capsys, clean_env):
    clean_env.setenv("PILOSA_TORCH_DATA_DIR", "/env/dir")
    rc, out = run_ctl(port_ctl, ["server", "--dry-run"], capsys)
    assert rc == 0 and 'data-dir = "/env/dir"' in out


def test_dry_run_imports_no_torch(tmp_path):
    toml = tmp_path / "c.toml"
    toml.write_text('[[schema.indexes]]\nname = "i"\n'
                    '[[schema.indexes.frames]]\nname = "f"\n'
                    '[[schema.indexes.frames.fields]]\nname = "v"\n'
                    'min = 0\nmax = 9\n')
    code = ("import sys; from pilosa_tpu_torch.ctl.main import main; "
            f"rc = main(['server', '-c', {str(toml)!r}, '--dry-run']); "
            "assert 'torch' not in sys.modules, 'torch imported'; "
            "sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, check=True).stdout
    assert 'name = "v"\nmin = 0\nmax = 9\n' in out


# -- the offline file tools ---------------------------------------------------------------


def fragment_files(tmp_path) -> list:
    """Data files the port wrote: a snapshot with footer and an op log,
    a file of ops only, an empty one, and one with its cookie flipped."""
    h = Holder(str(tmp_path / "d"))
    h.open()
    idx = h.create_index("i")
    f = idx.create_frame("f")
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 4, 6000).astype(np.uint64)
    cols = rng.integers(0, 2 * SLICE_WIDTH, 6000).astype(np.uint64)
    f.import_bits(rows, cols)
    for c in (5, 70000, SLICE_WIDTH + 3):
        f.set_bit(9, c)
    f.clear_bit(9, 5)
    h.close()
    paths = sorted(str(p) for p in (tmp_path / "d/i/f/standard/fragments")
                   .iterdir() if p.name.isdigit())
    bad = tmp_path / "bad"
    raw = bytearray(Path(paths[0]).read_bytes())
    raw[0] ^= 0xFF
    bad.write_bytes(bytes(raw))
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    return paths + [str(empty), str(bad)]


def test_check_gives_the_jax_output(tmp_path, capsys):
    paths = fragment_files(tmp_path)
    for argv in (["check", *paths[:2]], ["check", *paths]):
        port = run_ctl(port_ctl, argv, capsys)
        assert port == run_ctl(jax_ctl, argv, capsys)
    rc, out = port
    assert rc == 1 and "ok (" in out and f"{paths[-1]}: " in out
    rc, out = run_ctl(port_ctl, ["check", *paths[:2]], capsys)
    assert rc == 0


def test_inspect_gives_the_jax_output(tmp_path, capsys):
    for path in fragment_files(tmp_path)[:2]:
        port = run_ctl(port_ctl, ["inspect", path], capsys)
        assert port == run_ctl(jax_ctl, ["inspect", path], capsys)
        assert port[0] == 0 and "containers" in json.loads(port[1])


def test_bitmap_check_finds_what_the_jax_check_finds():
    from pilosa_tpu.roaring import Bitmap as JaxBitmap
    from pilosa_tpu_torch.roaring import Bitmap

    out = []
    for cls in (Bitmap, JaxBitmap):
        b = cls([1, 2, 70000, 3 << 16])
        b.containers[0].array = np.array([2, 1], dtype=np.uint32)
        b.keys[1], b.keys[2] = b.keys[2], b.keys[1]
        out.append((b.check(), b.info()))
    assert out[0] == out[1]
    assert "keys out of order at 2" in out[0][0]


def test_sort_gives_the_jax_output(tmp_path, capsys):
    p = tmp_path / "bits.csv"
    rng = np.random.default_rng(1)
    lines = [f"{r},{c}" for r, c in zip(rng.integers(0, 9, 200),
                                        rng.integers(0, 4 * SLICE_WIDTH, 200))]
    lines += ["3,7,2017-04-02T09:30", f"5,{SLICE_WIDTH}", "1,7", "0,9"]
    p.write_text("\n".join(lines) + "\n")
    port = run_ctl(port_ctl, ["sort", str(p)], capsys)
    assert port == run_ctl(jax_ctl, ["sort", str(p)], capsys)
    out = port[1].splitlines()
    assert "3,7,2017-04-02T09:30" in out and len(out) == len(lines)
    keys = [(int(c) // SLICE_WIDTH, int(r) * SLICE_WIDTH + int(c) %
             SLICE_WIDTH) for r, c, *_ in (x.split(",") for x in out)]
    assert keys == sorted(keys)


# -- bench against a live node of each package ---------------------------------------------


@pytest.fixture
def nodes(tmp_path):
    """A JAX node and a port node (CPU), each on a free port."""
    out = {}
    jc = JaxConfig()
    jc.data_dir = str(tmp_path / "jax")
    jc.host = f"127.0.0.1:{free_port()}"
    jc.cluster_hosts = [jc.host]
    jc.anti_entropy_interval = jc.polling_interval = 3600
    jsrv = JaxServer(jc)
    jsrv.open()
    out["jax"] = jsrv.host
    pc = Config.from_toml(f'data-dir = "{tmp_path / "port"}"\n'
                          'host = "127.0.0.1:0"\nuse-device = "off"\n', True)
    psrv = Server(pc)
    psrv.open()
    out["port"] = psrv.host
    yield out
    psrv.close()
    jsrv.close()


def test_bench_gives_the_jax_data(nodes, capsys):
    """The same seeded bench ops against both nodes: each prints one
    JSON line, and the index they write answers the same Count,
    TopN and export on both."""
    for host in (nodes["jax"], nodes["port"]):
        mod = jax_ctl if host == nodes["jax"] else port_ctl
        for op, n, extra in (("set-bit", 20, []),
                             ("intersect-count", 5, []),
                             ("topn", 5, ["--max-row-id", "8",
                                          "--max-column-id", "500"])):
            rc, out = run_ctl(mod, ["bench", "--host", host, "--op", op,
                                    "-n", str(n), *extra], capsys)
            res = json.loads(out)
            assert rc == 0 and res["op"] == op and res["n"] == n
            assert res["ops_per_sec"] > 0
    client = InternalClient(nodes["port"])
    q = ("Count(Intersect(Bitmap(rowID=1, frame='general'), "
         "Bitmap(rowID=2, frame='general')))TopN(frame='general', n=10)")
    got = client.execute_query("bench", q)
    from pilosa_tpu.api.client import InternalClient as JaxClient

    want = JaxClient(nodes["jax"]).execute_query(None, "bench", q, [],
                                                 remote=False)
    assert got[0] == want[0]
    assert [(p["id"], p["count"]) for p in got[1]] == [
        tuple(p) for p in want[1]]
    export = client.export_csv("bench", "general", "standard", 0)
    bits = {tuple(map(int, ln.split(","))) for ln in export.split()}
    rows = {r: {c for rr, c in bits if rr == r} for r, _ in bits}
    assert got[0] == len(rows[1] & rows[2])
    counts = sorted(((len(c), r) for r, c in rows.items()),
                    key=lambda x: (-x[0], x[1]))[:10]
    assert [(p["id"], p["count"]) for p in got[1]] == [(r, n)
                                                       for n, r in counts]


# -- Server -----------------------------------------------------------------------------------

SCHEMA = ('[[schema.indexes]]\nname = "cfg"\ncolumn-label = "col"\n'
          '[[schema.indexes.frames]]\nname = "f"\nrow-label = "row"\n'
          '[[schema.indexes.frames.fields]]\nname = "val"\n'
          'min = -1000\nmax = 1000\n'
          '[[schema.indexes.frames]]\nname = "g"\n'
          '[[schema.indexes]]\nname = "other"\n')


def test_server_applies_the_schema_twice_as_jax(tmp_path):
    schemas = []
    for name, cls, srv_cls in (("jax", JaxConfig, JaxServer),
                               ("port", Config, Server)):
        cfg = cls.from_toml(f'data-dir = "{tmp_path / name}"\n'
                            'host = "127.0.0.1:0"\nuse-device = "off"\n'
                            + SCHEMA, is_text=True)
        cfg.anti_entropy_interval = cfg.polling_interval = 3600
        for _ in range(2):
            srv = srv_cls(cfg)
            srv.open(port=0)
            schemas.append(srv.holder.schema())
            srv.close()
    assert schemas[0] == schemas[1]
    assert schemas[2] == schemas[3] == schemas[0]
    frames = {f["name"]: f for f in schemas[2][0]["frames"]}
    assert frames["f"]["meta"]["fields"][0]["name"] == "val"


def test_server_warm_and_cache_flush(tmp_path):
    cfg = Config.from_toml(f'data-dir = "{tmp_path}"\nhost = "127.0.0.1:0"\n'
                           'use-device = "off"\n', is_text=True)
    srv = Server(cfg)
    srv.open(port=0)
    host = srv.host
    assert host != "127.0.0.1:0" and srv.host.startswith("127.0.0.1:")
    client = InternalClient(host)
    client.create_index("i")
    client.create_frame("i", "f")
    client.execute_query("i", "".join(
        f"SetBit(rowID=1, frame=f, columnID={c})"
        for c in (1, SLICE_WIDTH + 1, 2 * SLICE_WIDTH + 1)))
    srv.holder.flush_caches()
    caches = list(tmp_path.glob("i/f/standard/fragments/*.cache"))
    assert len(caches) == 3
    srv.close()
    srv = Server(cfg)
    srv.open(port=0)
    try:
        for t in srv._threads:
            if t.name == "warm":
                t.join(timeout=30)
        assert not any(f._pending_load for f in srv.holder.fragments())
        assert InternalClient(srv.host).execute_query(
            "i", "Count(Bitmap(rowID=1, frame=f))") == [3]
    finally:
        srv.close()


def test_warm_skips_a_fragment_that_fails_to_load(tmp_path):
    h = Holder(str(tmp_path))
    h.open()
    f = h.create_index("i").create_frame("f")
    f.set_bit(1, 1)
    f.set_bit(1, SLICE_WIDTH + 1)
    h.close()
    path = tmp_path / "i/f/standard/fragments/0"
    raw = bytearray(path.read_bytes())
    raw[0] ^= 0xFF
    path.write_bytes(bytes(raw))
    h = Holder(str(tmp_path))
    h.open()
    try:
        h.warm()
        frags = {fr.slice: fr for fr in h.fragments()}
        assert frags[0]._pending_load and not frags[1]._pending_load
        with pytest.raises(Exception, match="corrupt"):
            frags[0].storage
    finally:
        h.close()


# -- `ctl server` as a child process ----------------------------------------------------------


def start_child(toml: Path, log: Path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_TORCH_")}
    out = open(log.with_suffix(".out"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.ctl", "server", "-c",
         str(toml)], cwd=str(REPO), env=env, stdout=out,
        stderr=subprocess.STDOUT)
    return proc


def wait_up(proc, host: str, log: Path):
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"http://{host}/version",
                                        timeout=2) as r:
                return json.loads(r.read())["version"]
        except OSError:
            assert proc.poll() is None, log.with_suffix(".out").read_text()
            time.sleep(0.2)
    raise AssertionError("server did not come up")


def test_ctl_server_child_from_a_config(tmp_path):
    """`ctl server -c node.toml` on the CPU: the declared schema, a
    query, JSON logs, SIGTERM -> rc 0; the files it leaves pass `ctl
    check`; a second start applies the schema again and answers the
    same."""
    port = free_port()
    host = f"127.0.0.1:{port}"
    log = tmp_path / "node.log"
    toml = tmp_path / "node.toml"
    toml.write_text(f'data-dir = "{tmp_path / "data"}"\nhost = "{host}"\n'
                    'use-device = "off"\n'
                    '[storage]\nfsync-policy = "group"\nmax-op-n = 5\n'
                    '[integrity]\nshadow-sample-1-in = 1\n'
                    f'[log]\nformat = "json"\nlevel = "info"\n'
                    f'path = "{log}"\n' + SCHEMA)
    answers = []
    for run in range(2):
        proc = start_child(toml, log)
        try:
            assert wait_up(proc, host, log) == "0.1.0"
            client = InternalClient(host)
            schema = {ix["name"]: ix for ix in client.schema()}
            assert set(schema) == {"cfg", "other"}
            if run == 0:
                client.execute_query("cfg", "".join(
                    f"SetBit(row={r}, frame=f, col={c})"
                    for r, c in ((1, 3), (1, SLICE_WIDTH + 3), (2, 3),
                                 (2, 9))) + "SetValue(frame=f, col=3, "
                    "val=-7)SetValue(frame=f, col=9, val=12)")
            answers.append(client.execute_query(
                "cfg", "Count(Intersect(Bitmap(row=1, frame=f), "
                "Bitmap(row=2, frame=f)))Sum(frame=f, field=\"val\")"
                "Count(Range(frame=f, val > 0))"))
            with urllib.request.urlopen(f"http://{host}/metrics") as r:
                text = r.read().decode()
            assert 'pilosa_build_info{version="0.1.0"} 1' in text
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        assert rc == 0, log.with_suffix(".out").read_text()
        lines = log.read_text().splitlines()
        assert lines and all(json.loads(ln)["component"].startswith(
            "pilosa_tpu_torch") for ln in lines)
        assert any("not acted on" in json.loads(ln)["msg"] for ln in lines)
        files = sorted(str(p) for p in tmp_path.glob(
            "data/cfg/f/*/fragments/*") if p.name.isdigit())
        rc = port_ctl.main(["check", *files])
        assert rc == 0 and len(files) == 3
    assert answers[0] == answers[1] == [1, {"value": 5, "count": 2}, 1]
