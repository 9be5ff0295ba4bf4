"""The port stands alone: it imports neither jax nor the JAX package, and
it never drops to the CPU behind the caller's back."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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

post("/index/i", "{}")
post("/index/i/frame/f", "{}")
post("/index/i/query", "SetBit(rowID=1, frame=f, columnID=7)")
post("/index/i/query", "SetBit(rowID=2, frame=f, columnID=7)")
out = post("/index/i/query",
           "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))")
srv.close()
h.close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "pilosa_tpu" or m.startswith("pilosa_tpu."))
print(json.dumps({"results": out["results"], "bad": bad}))
"""


def test_served_query_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SERVE_ONE_QUERY, str(REPO)], env=env,
        capture_output=True, text=True, timeout=120, check=True)
    last = out.stdout.strip().splitlines()[-1]
    assert last == '{"results": [1], "bad": []}', out.stderr


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
        for make in (resolve_device, lambda d: Executor(h, device=d),
                     lambda d: MeshManager(h, device=d)):
            with pytest.raises(RuntimeError, match="cuda"):
                make("cuda")
        # The default is the card, too.
        with pytest.raises(RuntimeError):
            Executor(h)
    finally:
        h.close()
