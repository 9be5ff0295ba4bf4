"""The port's command line: `python -m pilosa_tpu_torch.ctl` (or the
`pilosa-tpu-torch` script) with the subcommands import, export, backup
and restore (ctl/main.py)."""
