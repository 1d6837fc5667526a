"""Analytical cost models from the paper (Tables 2, 4, 5; Eqs. 1-3).
A copy of ``repro/core/cost_model.py`` (framework-free).

These models drive template selection (TCG vs TDG), predict the paper's
headline speedups (~2.5x serving, ~5x sync training), and provide the
LGR time-complexity comparison used by the benchmark for Table 7.

Paper empirical constants (§5.1): alpha ~= 0.2, beta ~= 0.3,
R_s ~= 10 R_a ~= 5 R_t, T_s ~= 6 T_a ~= 3 T_t.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WorkloadProfile:
    """Per-role dominant-resource sizes and per-iteration times (Table 3)."""
    R_s: float = 10.0     # simulator resource
    R_a: float = 1.0      # agent resource
    R_t: float = 2.0      # trainer resource  (R_s ≈ 5 R_t)
    T_s: float = 6.0      # simulator time
    T_a: float = 1.0      # agent time        (T_s ≈ 6 T_a)
    T_t: float = 2.0      # trainer time      (T_s ≈ 3 T_t)
    alpha: float = 0.2    # sharing ratio: many sims per agent
    beta: float = 0.3     # sharing ratio: many sims per trainer
    R_all: float = 80.0   # total resource pool (e.g. 8 GPUs x 10 units)


# --------------------------------------------------- Table 2: LGR times ----
def lgr_time_mpr(g: int, t: int, M_p: float, B1: float, B2: float) -> float:
    return 2 * (g * t - 1) * M_p / (g * t * B1)


def lgr_time_mrr(g: int, t: int, M_p: float, B1: float, B2: float) -> float:
    return 2 * (g - 1) * (t + 1) * M_p / (g * B2)


def lgr_time_har(g: int, t: int, M_p: float, B1: float, B2: float) -> float:
    return 2 * (g - 1) * M_p / (g * B2) + 2 * (t - 1) * M_p / (t * B1)


def lgr_time_har3(g: int, t: int, d: int, M_p: float, B1: float,
                  B2: float, B3: float) -> float:
    """3-level HAR over a (gpu=g, inst=t, dev=d) grid: the dev-level
    scatter/gather rides the fastest links (B3, intra-instance chips),
    the inst level works on 1/d shards over B1, and the cross-GPU ring
    works on 1/(t·d) shards over B2 — the Table-2 recurrence applied one
    level deeper."""
    return (2 * (d - 1) * M_p / (d * B3)
            + 2 * (t - 1) * M_p / (d * t * B1)
            + 2 * (g - 1) * M_p / (t * d * g * B2))


LGR_TIMES = {"mpr": lgr_time_mpr, "mrr": lgr_time_mrr, "har": lgr_time_har}


def lgr_coeffs(strategy: str, g: int, t: int, d: int, M_p: float) \
        -> tuple:
    """Per-axis byte coefficients of the Table-2 recurrences.

    Every ``lgr_time_*`` form above is linear in the *inverse* bandwidths:
    ``time == c1/B1 + c2/B2 + c3/B3``.  This returns ``(c1, c2, c3)`` —
    the design row the bandwidth calibrator
    (:class:`repro_torch.comm.calibrate.BandwidthCalibrator`) inverts to fit
    effective B1/B2/B3 from measured reduce seconds.  The 2-level forms
    (mpr/mrr/har) take the merged instance count as ``t`` and ignore
    ``d``, mirroring how :class:`repro_torch.comm.select.ReduceCostModel`
    evaluates them.
    """
    if strategy == "mpr":
        return (2 * (g * t - 1) * M_p / (g * t), 0.0, 0.0)
    if strategy == "mrr":
        return (0.0, 2 * (g - 1) * (t + 1) * M_p / g, 0.0)
    if strategy == "har":
        return (2 * (t - 1) * M_p / t, 2 * (g - 1) * M_p / g, 0.0)
    if strategy == "har3":
        return (2 * (t - 1) * M_p / (d * t),
                2 * (g - 1) * M_p / (t * d * g),
                2 * (d - 1) * M_p / d)
    raise ValueError(f"unknown reduction strategy {strategy!r}")


def best_lgr(g: int, t: int, M_p: float, B1: float, B2: float) -> str:
    feasible = {"mpr", "har"} | ({"mrr"} if t <= g else set())
    return min(feasible, key=lambda s: LGR_TIMES[s](g, t, M_p, B1, B2))


# ------------------------------------------- Table 4: serving templates ----
def serving_resource_tdg(w: WorkloadProfile) -> float:
    return (w.T_s * w.R_s + w.T_a * w.alpha * w.R_a) / (w.T_s + w.T_a)


def serving_resource_tcg(w: WorkloadProfile) -> float:
    return (w.T_s + w.T_a) * max(w.R_s, w.R_a) / (w.T_s + w.T_a)


def serving_com_tdg(S: float, A: float, W: float) -> float:
    return 2 * S + A + W


def serving_throughput(w: WorkloadProfile, R: float, com_over_bw: float) \
        -> float:
    """Eq. 2: TOP = (R_all / R) * 1 / (T_s + T_a + COM/BW)."""
    return (w.R_all / R) / (w.T_s + w.T_a + com_over_bw)


def serving_speedup_tcg_over_tdg(w: WorkloadProfile = WorkloadProfile()) \
        -> float:
    """Paper §5.1: ~2.5x, with COM/BW ≈ 2·(T_s+T_a) for TDG."""
    r_tdg = serving_resource_tdg(w)
    r_tcg = serving_resource_tcg(w)
    top_tdg = serving_throughput(w, r_tdg, 2.0 * (w.T_s + w.T_a))
    top_tcg = serving_throughput(w, r_tcg, 0.0)
    return top_tcg / top_tdg


# ------------------------------------------ Table 5: training templates ----
def training_resource_tdg_ex(w: WorkloadProfile) -> float:
    return (w.T_s * w.R_s + w.T_a * w.alpha * w.R_a
            + w.T_t * w.beta * w.R_t) / (w.T_s + w.T_a + w.T_t)


def training_resource_tcg_ex(w: WorkloadProfile) -> float:
    return max(w.R_s, w.R_a, w.R_t)


def training_com_tdg_ex(m: int, S: float, A: float, W: float, M_p: float,
                        n: int) -> float:
    return m * (S + A + W) + M_p + 2 * (n - 1) * M_p / n


def training_com_tcg_ex(M_p: float, n: int) -> float:
    return 2 * (n - 1) * M_p / n


def training_throughput(w: WorkloadProfile, R: float, com_over_bw: float) \
        -> float:
    """Eq. 3."""
    return (w.R_all / R) / (w.T_s + w.T_a + w.T_t + com_over_bw)


def training_speedup_tcg_over_tdg(w: WorkloadProfile = WorkloadProfile()) \
        -> float:
    """Paper §5.1: ~5x, with COM/BW ≈ 7·(T_s+T_a+T_t) for TDG_EX and the
    gradient-ring only for TCG_EX (≈ 0.35·cycle on the paper's profile)."""
    r_tdg = training_resource_tdg_ex(w)
    r_tcg = training_resource_tcg_ex(w)
    cyc = w.T_s + w.T_a + w.T_t
    top_tdg = training_throughput(w, r_tdg, 7.0 * cyc)
    top_tcg = training_throughput(w, r_tcg, 0.35 * cyc)
    return top_tcg / top_tdg


# ------------------------------------------------------- Eq. 1: resource ---
def dominant_resource(R_sm: float, sm_per_gpu: float, R_mem: float,
                      mem_per_gpu: float) -> str:
    return "SM" if R_sm / sm_per_gpu >= R_mem / mem_per_gpu else "Memory"


# --------------------------------------- cache migration (disaggregation) ---
# Prefill/decode disaggregation prices a finished prefill cache shipped
# from a prefill GMI to a decode GMI in the SAME units as Table 2: a
# point-to-point transfer over one of the B1/B2/B3 bandwidth tiers.  The
# alternative is running the prompt's prefill locally on the decode GMI,
# which stalls its whole decode batch for the prefill duration.

def migration_time(nbytes: float, bandwidth: float,
                   latency_s: float = 0.0) -> float:
    """Seconds to ship ``nbytes`` of packed cache over a ``bandwidth``
    bytes/s link (calibrated B1/B2 in practice) plus a fixed per-transfer
    ``latency_s`` (pack/unpack + ring hop)."""
    return latency_s + nbytes / max(bandwidth, 1e-9)


def local_prefill_time(prompt_tokens: int, prefill_tok_s: float) -> float:
    """Seconds the decode batch stalls if the decode GMI prefills this
    prompt itself, from a measured prefill throughput (tokens/s)."""
    return prompt_tokens / max(prefill_tok_s, 1e-9)


def migration_gain(nbytes: float, prompt_tokens: int, bandwidth: float,
                   prefill_tok_s: float, latency_s: float = 0.0) -> float:
    """Ratio local-prefill-stall / migration-cost.  > 1 means shipping
    the prefilled cache beats recomputing the prefill on the decode GMI;
    compare against the controller's ``min_gain`` (1.05x) hysteresis so
    the per-request decision and the GMI arbiter share one threshold."""
    return (local_prefill_time(prompt_tokens, prefill_tok_s)
            / max(migration_time(nbytes, bandwidth, latency_s), 1e-12))


def migration_beats_local(nbytes: float, prompt_tokens: int,
                          bandwidth: float, prefill_tok_s: float,
                          latency_s: float = 0.0,
                          min_gain: float = 1.05) -> bool:
    return migration_gain(nbytes, prompt_tokens, bandwidth,
                          prefill_tok_s, latency_s) >= min_gain


# ------------------------------------------- paged cache migration pricing ---
# With paged decode caches the migration unit is the fixed-size page, not
# the monolithic per-slot cache: a payload ships only the pages its prompt
# actually filled (minus any pages the destination already holds in its
# shared-prefix index), so the wire cost scales with ceil(prompt/page)
# instead of with max_seq.  These helpers keep the per-request
# migrate-vs-local decision in the same Table-2 units as above.

def pages_for_tokens(tokens: int, page_size: int) -> int:
    """Physical pages covering ``tokens`` cache entries."""
    return -(-max(int(tokens), 0) // max(int(page_size), 1))


def paged_migration_bytes(prompt_tokens: int, page_size: int,
                          page_bytes: float, shared_head_pages: int = 0)\
        -> float:
    """Wire bytes for a page-wise cache payload: the prompt's pages minus
    the leading ``shared_head_pages`` already resident on the decode GMI
    (shared-prefix dedup — those pages migrate once per decode GMI, not
    once per request)."""
    pages = pages_for_tokens(prompt_tokens, page_size)
    return max(pages - max(int(shared_head_pages), 0), 0) * float(page_bytes)


def paged_migration_time(prompt_tokens: int, page_size: int,
                         page_bytes: float, bandwidth: float,
                         latency_s: float = 0.0,
                         shared_head_pages: int = 0) -> float:
    """Seconds to ship a page-wise payload (fixed hop latency + pages on
    the wire)."""
    return migration_time(
        paged_migration_bytes(prompt_tokens, page_size, page_bytes,
                              shared_head_pages), bandwidth, latency_s)


def migration_crossover_tokens(page_size: int, page_bytes: float,
                               bandwidth: float, prefill_tok_s: float,
                               latency_s: float = 0.0,
                               min_gain: float = 1.05,
                               max_tokens: int = 1 << 20) -> int:
    """Smallest prompt length whose page-wise migration beats local
    prefill (the bench_disagg crossover row).  Returns ``max_tokens`` when
    migration never wins below that bound (e.g. bandwidth too low)."""
    for n in range(1, int(max_tokens) + 1):
        t_mig = paged_migration_time(n, page_size, page_bytes, bandwidth,
                                     latency_s)
        if local_prefill_time(n, prefill_tok_s) >= min_gain * t_mig:
            return n
    return int(max_tokens)
