"""Recompute the op counter's fields of dry-run records from the saved
(gzipped) traces — lets the counter's definitions evolve without tracing
again (port of ``repro/launch/reanalyze.py``).

  PYTHONPATH=src python -m repro_torch.launch.reanalyze \
      --dryrun artifacts/dryrun --hlo artifacts/hlo

``--hlo`` is the directory that ``dryrun.py --save-hlo`` wrote, one
``ARCH_SHAPE_MESH.hlo.gz`` trace a cell (the whole step) and beside it
``ARCH_SHAPE_MESH_rank0.hlo.gz`` (rank 0's program, the ``per_device_*``
fields and ``cross_pod_bytes``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.hlo_analysis import (analyze, dot_redundancy,
                                             load_trace)

# record key -> the counter's key
FIELDS = {"hlo_dot_flops": "dot_flops",
          "hlo_plain_fwd_dot_flops": "plain_fwd_dot_flops",
          "hlo_traffic_bytes": "traffic_bytes",
          "collective_bytes": "collective_bytes", "coll_by_op": "coll_by_op",
          "coll_counts": "coll_counts", "kernel_flops": "kernel_flops",
          "kernel_bytes": "kernel_bytes", "kernel_calls": "kernel_calls",
          "mem_argument_bytes": "mem_argument_bytes",
          "mem_output_bytes": "mem_output_bytes",
          "mem_temp_bytes": "mem_temp_bytes",
          "mem_alias_bytes": "mem_alias_bytes"}
# the same for rank 0's trace
RANK_FIELDS = {"per_device_dot_flops": "dot_flops",
               "per_device_plain_fwd_dot_flops": "plain_fwd_dot_flops",
               "per_device_collective_bytes": "collective_bytes",
               "per_device_temp_bytes": "mem_temp_bytes",
               "per_device_argument_bytes": "mem_argument_bytes",
               "per_device_coll_by_op": "coll_by_op",
               "per_device_coll_counts": "coll_counts",
               "per_device_kernel_calls": "kernel_calls",
               "per_device_kernel_flops": "kernel_flops",
               "cross_pod_bytes": "cross_pod_bytes"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="artifacts/dryrun")
    ap.add_argument("--hlo", default="artifacts/hlo")
    args = ap.parse_args(argv)
    n = 0
    for jpath in sorted(glob.glob(os.path.join(args.dryrun, "*.json"))):
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        mesh_tag = "multi" if rec["mesh"] == "2x16x16" else "single"
        hpath = os.path.join(
            args.hlo, f"{rec['arch']}_{rec['shape']}_{mesh_tag}.hlo.gz")
        if not os.path.exists(hpath):
            continue
        hl = analyze(load_trace(hpath))
        rec.update({k: hl[v] for k, v in FIELDS.items()})
        rec["mem_per_device_bytes"] = (hl["mem_argument_bytes"]
                                       + hl["mem_temp_bytes"])
        rpath = hpath.replace(".hlo.gz", "_rank0.hlo.gz")
        if os.path.exists(rpath):
            pd = analyze(load_trace(rpath))
            rec.update({k: pd[v] for k, v in RANK_FIELDS.items()})
            rec["per_device_mem_bytes"] = (pd["mem_argument_bytes"]
                                           + pd["mem_temp_bytes"])
            rec["dot_redundancy"] = dot_redundancy(hl, pd, rec["chips"])
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"reanalyzed {n} records")


if __name__ == "__main__":
    main()
