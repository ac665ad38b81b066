#!/usr/bin/env python
"""Benchmark driver: prints ONE JSON line
    {"metric": ..., "value": N, "unit": "pairs/s", "device": {...}, ...}

Metric: effective interactions/s of the Laplace-BEM-sphere FMM matvec,
with the solve times and per-phase record beside it.  The measurement
runs in one subprocess (``python -m fmm_bem_tpu.utils.bench_impl``), so
this parent never touches JAX and only one JAX process holds the card.
A host without a GPU fails: the subprocess exits non-zero and no
metric is printed.

Environment: FMM_BENCH_RECURSIONS (default 8: 131,072 panels),
FMM_BENCH_TIMEOUT (seconds, default 1100).
"""

import json
import os
import subprocess
import sys

REC = int(os.environ.get("FMM_BENCH_RECURSIONS", "8"))
TIMEOUT = float(os.environ.get("FMM_BENCH_TIMEOUT", "1100"))
_HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    out = subprocess.run(
        [sys.executable, "-m", "fmm_bem_tpu.utils.bench_impl", str(REC)],
        stdout=subprocess.PIPE,
        text=True,
        timeout=TIMEOUT,
        cwd=_HERE,
    )
    if out.returncode != 0:
        return out.returncode
    record = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps({
        "metric": "laplace_bem_fmm_matvec_interactions_per_s",
        "value": record.pop("value"),
        "unit": "pairs/s",
        **record,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
