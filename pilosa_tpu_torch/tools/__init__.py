"""The on-chip probes of the port, each named after its JAX twin under
tools/: probe_r5_bw (coarse-count bandwidth and the stream ceiling),
probe_r5 (stage, readback, kernels), profile_stage (the cold staging
split) and profile_headline (the headline Count, layer by layer).

    python -m pilosa_tpu_torch.tools.<name> [--device cuda|cpu]
        [--out DIR] [--slices N] [--reps N]
"""
