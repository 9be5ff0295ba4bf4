"""The port's tools, each named after its JAX twin under tools/.

The on-chip probes: probe_r5_bw (coarse-count bandwidth and the stream
ceiling), probe_r5 (stage, readback, kernels), profile_stage (the cold
staging split) and profile_headline (the headline Count, layer by layer):

    python -m pilosa_tpu_torch.tools.<name> [--device cuda|cpu]
        [--out DIR] [--slices N] [--reps N]

The operator's load and lint tools: loadgen (seeded traffic with SLO
verdicts against one node; `python -m pilosa_tpu_torch.ctl loadgen`)
and metrics_lint (the /metrics conventions gate):

    python -m pilosa_tpu_torch.ctl loadgen [--in-process] [--host H:P] ...
    python -m pilosa_tpu_torch.tools.metrics_lint [--url URL | --file F]

The density sweep (sparse_sweep): each density's pair served through
MeshManager.count and gated on the host fold's C++ kernels:

    python -m pilosa_tpu_torch.tools.sparse_sweep [--device cuda|cpu]
        [--slices 8] [--iters 5] [--densities 0.003,0.03,0.3] [--out F]
"""
