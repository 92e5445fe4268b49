"""Dump safetensors tensor names, shapes and dtypes, and per-prefix
summaries (inspect_weights.c analog).

PyTorch counterpart of tools/inspect_weights.py, through the port's
io/safetensors.py; it prints the same lines.

Usage:

    python -m voxtral_tpu_torch.tools.inspect_weights MODEL_DIR_OR_FILE
        [--prefix P]
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    from ..io.safetensors import SafetensorsFile

    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 1
    path = argv[0]
    if os.path.isdir(path):
        path = os.path.join(path, "consolidated.safetensors")
    prefix = None
    if "--prefix" in argv:
        prefix = argv[argv.index("--prefix") + 1]

    sf = SafetensorsFile(path)
    totals: dict[str, tuple[int, int]] = {}
    n_shown = 0
    for name in sorted(sf.names()):
        shape = sf.shape(name)
        dtype = sf.dtype(name)
        numel = 1
        for s in shape:
            numel *= s
        nbytes = numel * dtype.itemsize
        top = name.split(".")[0]
        c, b = totals.get(top, (0, 0))
        totals[top] = (c + numel, b + nbytes)
        if prefix is None or name.startswith(prefix):
            # the numpy dtype name ("bfloat16"), as the JAX tool prints it
            dname = str(dtype).removeprefix("torch.")
            print(f"{name:80s} {dname:10s} {str(list(shape)):24s} "
                  f"{nbytes / 1e6:10.2f} MB")
            n_shown += 1
    print(f"\n{n_shown} tensors shown. Prefix summary:", file=sys.stderr)
    gp = gb = 0
    for top, (numel, nbytes) in sorted(totals.items()):
        print(f"  {top:40s} {numel / 1e6:10.1f} M params "
              f"{nbytes / 1e9:8.2f} GB", file=sys.stderr)
        gp += numel
        gb += nbytes
    print(f"  {'TOTAL':40s} {gp / 1e6:10.1f} M params {gb / 1e9:8.2f} GB",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
