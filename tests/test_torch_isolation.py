"""The port stands alone: it imports neither jax nor the JAX package, and
it never drops to the CPU behind the caller's back."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pilosa_tpu_torch"

SERVE_ONE_QUERY = r"""
import json, sys, tempfile, urllib.request
sys.path.insert(0, sys.argv[1])
from pilosa_tpu_torch.api.server import serve
from pilosa_tpu_torch.core import Holder

h = Holder(tempfile.mkdtemp())
h.open()
srv = serve(h, device="cpu")
host, port = srv.address

def post(path, body):
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 data=body.encode(), method="POST")
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())

post("/index/i", '{"options": {"timeQuantum": "YMD"}}')
post("/index/i/frame/f", "{}")
post("/index/i/query", 'SetBit(rowID=1, frame=f, columnID=7, '
                       'timestamp="2017-04-02T09:00")')
post("/index/i/query", "SetBit(rowID=2, frame=f, columnID=7)")
post("/index/i/query", 'SetRowAttrs(frame=f, rowID=2, cat="a")')
out = post("/index/i/query",
           "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))"
           ' Count(Range(rowID=1, frame=f, start="2017-04-01T00:00",'
           ' end="2017-05-01T00:00"))'
           ' TopN(frame=f, n=1, field="cat", filters=["a"])')
srv.close()
h.close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "pilosa_tpu" or m.startswith("pilosa_tpu."))
new = [m for m in ("pilosa_tpu_torch.core.timequantum",
                   "pilosa_tpu_torch.core.cache",
                   "pilosa_tpu_torch.core.attr") if m not in sys.modules]
print(json.dumps({"results": out["results"], "bad": bad, "unused": new}))
"""


def test_served_query_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SERVE_ONE_QUERY, str(REPO)], env=env,
        capture_output=True, text=True, timeout=120, check=True)
    last = out.stdout.strip().splitlines()[-1]
    assert json.loads(last) == {
        "results": [1, 1, [{"id": 2, "count": 1}]], "bad": [],
        "unused": []}, out.stderr


def test_no_source_names_the_jax_package():
    pat = re.compile(r"\bpilosa_tpu\.|^\s*(import|from)\s+jax\b", re.M)
    offenders = [str(p.relative_to(REPO))
                 for p in sorted(PORT.rglob("*"))
                 if p.suffix in (".py", ".cu", ".cuh")
                 and pat.search(p.read_text())]
    assert offenders == []


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from pilosa_tpu_torch import resolve_device
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel.serve import MeshManager

    h = Holder(str(tmp_path))
    h.open()
    try:
        from pilosa_tpu_torch.api.server import serve

        for make in (resolve_device, lambda d: Executor(h, device=d),
                     lambda d: MeshManager(h, device=d),
                     lambda d: serve(h, device=d)):
            with pytest.raises(RuntimeError, match="cuda"):
                make("cuda")
        # The default is the card, too.
        with pytest.raises(RuntimeError):
            Executor(h)
    finally:
        h.close()


FIELD_VALUES = {3: 17, 9: -1000, 1 << 20: 1000, (2 << 20) + 5: 0,
                (2 << 20) + 6: -3}
FIELD_QUERIES = ['Sum(frame=f, field="val")', 'Min(frame=f, field="val")',
                 'Max(frame=f, field="val")',
                 "Count(Range(frame=f, val < 0))"]
FIELD_ANSWERS = [{"value": 14, "count": 5}, {"value": -1000, "count": 1},
                 {"value": 1000, "count": 1}, 2]


def test_fields_written_by_the_port_open_in_the_jax_package(tmp_path):
    from pilosa_tpu.bsi import FieldSchema as JaxSchema
    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.executor import Executor as JaxExecutor
    from pilosa_tpu.pql import parse_string as jax_parse
    from pilosa_tpu_torch.core import Holder

    h = Holder(str(tmp_path))
    h.open()
    f = h.create_index("i").create_frame(
        "f", fields=[{"name": "val", "min": -1000, "max": 1000}])
    for col, v in FIELD_VALUES.items():
        f.set_value("val", col, v)
    h.close()
    jh = JaxHolder(str(tmp_path))
    jh.open()
    try:
        assert jh.index("i").frame("f").fields == {
            "val": JaxSchema("val", -1000, 1000)}
        ex = JaxExecutor(jh, use_device=False)
        assert [ex.execute("i", jax_parse(q))[0]
                for q in FIELD_QUERIES] == FIELD_ANSWERS
    finally:
        jh.close()


def test_fields_written_by_the_jax_package_open_in_the_port(tmp_path):
    from pilosa_tpu.bsi import FieldSchema as JaxSchema
    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu_torch.bsi import FieldSchema
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql import parse_string

    jh = JaxHolder(str(tmp_path))
    jh.open()
    f = jh.create_index_if_not_exists("i").create_frame_if_not_exists("f")
    f.create_field_if_not_exists(JaxSchema("val", -1000, 1000))
    for col, v in FIELD_VALUES.items():
        f.set_value("val", col, v)
    jh.close()
    h = Holder(str(tmp_path))
    h.open()
    try:
        assert h.index("i").frame("f").fields == {
            "val": FieldSchema("val", -1000, 1000)}
        ex = Executor(h, device="cpu")
        assert [ex.execute("i", parse_string(q))[0]
                for q in FIELD_QUERIES] == FIELD_ANSWERS
        assert ex.stats["bsi_device"] == 3 and ex.stats["count_device"] == 1
    finally:
        h.close()
