"""MIG-style serving: models co-located on ONE card, each GMI an instance
of its own (runnable counterpart of ``examples/submesh_serving.py``).

Each GMI is registered with a ``GMIManager`` on the MIG-like ``submesh``
backend and gets its own context: its share of the manager's card's SMs
(a green context; half the card each here) and a stream on them, so its
work runs apart from every other instance's.  Part 1
runs two heterogeneous ``ServingRole`` instances (paper Listing 1's
serving GMI) side by side; part 2 puts a ``RequestRouter`` front over two
same-model GMIs and routes an open-loop request trace by queue depth,
printing per-GMI latency and throughput stats.  Models are the reduced
configs, weights random.

    PYTHONPATH=src python -m repro_torch.launch.submesh_serving --device cuda
    PYTHONPATH=src python -m repro_torch.launch.submesh_serving --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.core.gmi import GMIManager
from repro_torch.models import transformer as T
from repro_torch.serve import Request, RequestRouter, ServingRole
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- part 1: two serving GMIs, different models ------------------------
    mgr = GMIManager(devices=[0, 1], devices_per_gpu=2, backend="submesh",
                     device=device)
    roles = []
    for gmi_id, arch in zip([0, 1], ["internlm2-1.8b", "xlstm-1.3b"]):
        cfg = get_reduced(arch)
        params = T.init_model(gmi_id, cfg, device)
        role = ServingRole(mgr, gmi_id, 0, cfg, params,
                           resource_fraction=0.5, max_slots=4, max_seq=48)
        roles.append((role, arch, cfg))
        print(f"GMI {gmi_id}: {arch} on {role.engine.device}, stream "
              f"{role.engine.stream}")
    print(mgr.summary())

    rng = np.random.default_rng(7)
    for role, arch, cfg in roles:
        B, plen = 4, 24
        toks = rng.integers(0, cfg.vocab_size, (B, plen))
        t0 = time.time()
        done = role.gmi_run([Request(tokens=toks[i], max_new_tokens=13)
                             for i in range(B)])
        # results leave the instance through the host
        print(f"GMI {role.gmi_id} [{arch}] served {B} reqs x "
              f"{len(done[0].tokens)} tokens in "
              f"{1e3 * (time.time() - t0):.0f} ms; "
              f"sample: {done[0].tokens[:8]}")

    # ---- part 2: a router front over two same-model serving GMIs ----------
    arch = "internlm2-1.8b"
    cfg = get_reduced(arch)
    params = T.init_model(0, cfg, device)
    mgr2 = GMIManager(devices=[0, 1], devices_per_gpu=2, backend="submesh",
                      device=device)
    front = [ServingRole(mgr2, gmi_id, 0, cfg, params,
                         resource_fraction=0.5, max_slots=2, max_seq=48)
             for gmi_id in (0, 1)]
    router = RequestRouter([r.engine for r in front])
    print(f"\nrouter front: {router.num_engines} x {arch} GMIs")
    # open-loop trace: 2 arrivals per decode round, 10 rounds
    for _ in range(10):
        for _ in range(2):
            router.submit(Request(
                tokens=rng.integers(0, cfg.vocab_size, 12),
                max_new_tokens=8))
        router.step()
    router.drain()
    stats = router.per_gmi_stats()
    for role, st in zip(front, stats):
        print(f"GMI {role.gmi_id}: {st.requests} reqs, "
              f"{st.tokens} tokens, {st.tok_s:,.0f} tok/s, "
              f"p50={st.p50_s*1e3:.1f}ms p95={st.p95_s*1e3:.1f}ms")
    return router


if __name__ == "__main__":
    main()
