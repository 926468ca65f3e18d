"""Analytical time model (paper §IV, Eq. 10): per-client step time

    T_u = T_u^f + T_u^fc + T_u^w + T_u^s + T_u^bc + T_u^b

driven by real FLOP counts from the model config and the device profiles of
§V.  The container has no Jetsons/TPUs, so wall-clock terms for the
federated experiments come from this model (DESIGN.md §10); the scheduler
and the simulator both consume it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    tflops: float            # peak fp16/fp32-ish throughput, TFLOPS
    mem_gb: float            # usable memory for training
    utilization: float = 0.30  # achieved fraction of peak on transformer blocks


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Scalar NOMINAL link rate — what the closed-form Eq. 10 model plans
    with.  Time-varying links live in ``repro.net`` (the network plane);
    a LinkProfile is the degenerate constant case."""
    rate_mbps: float = 100.0   # paper §V: 100 Mbps up/down

    def transfer_s(self, num_bytes: float) -> float:
        return num_bytes * 8.0 / (self.rate_mbps * 1e6)


#: wire bytes per element for the activation dtypes the configs use
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def dtype_nbytes(dtype: str) -> int:
    try:
        return DTYPE_BYTES[dtype]
    except KeyError:
        raise KeyError(f"unknown activation dtype {dtype!r} "
                       f"(known: {sorted(DTYPE_BYTES)})") from None


# ---------------------------------------------------------------------------
# FLOPs accounting
# ---------------------------------------------------------------------------

def layer_param_count(cfg: ModelConfig) -> float:
    """Average parameters per block (active params for MoE routing)."""
    body = cfg.active_param_count()
    body -= cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.positional == "learned":
        body -= cfg.max_position * cfg.d_model
    if cfg.n_classes:
        body -= cfg.d_model * cfg.n_classes
    return max(body, 0) / max(cfg.n_layers + cfg.n_encoder_layers, 1)


def layer_fwd_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """2 FLOPs per param-MAC + the quadratic attention term (causal half)."""
    flops = 2.0 * layer_param_count(cfg)
    if cfg.n_heads:
        flops += 2.0 * seq_len * cfg.attn_dim  # qk^T + pv, causal averaged
    return flops


def head_fwd_flops_per_token(cfg: ModelConfig) -> float:
    out_dim = cfg.n_classes if cfg.n_classes else cfg.vocab_size
    return 2.0 * cfg.d_model * out_dim


def lora_flops_per_token_per_layer(cfg: ModelConfig,
                                   rank: Optional[int] = None) -> float:
    # two rank-r matmuls per adapted projection; coarse: 4 targets.
    # ``rank`` overrides cfg.lora.rank (the control plane's rank knob).
    r = cfg.lora.rank if rank is None else int(rank)
    return 2.0 * len(cfg.lora.targets) * r * 2 * cfg.d_model


BWD_FACTOR = 2.0   # backward ~ 2x forward (dgrad through frozen + LoRA wgrad)


@dataclasses.dataclass(frozen=True)
class StepTimes:
    """All Eq. 10 terms for one client (seconds); T^w filled by the scheduler.

    ``t_fc``/``t_bc`` are the NOMINAL-rate transfer durations the analytic
    closed form (``makespan``) and the offline schedulers plan with.
    ``fc_bytes``/``bc_bytes`` are the payload sizes those durations were
    derived from — the network plane (``repro.net``) integrates BYTES over
    its time-varying rates, so the event engines treat the byte counts as
    authoritative whenever a plane is attached and fall back to the nominal
    seconds otherwise (raw jobs built without payload sizes)."""
    t_f: float     # client-side forward
    t_fc: float    # activation upload (nominal-rate seconds)
    t_s: float     # server fwd+bwd for this client's remaining layers
    t_bc: float    # activation-gradient download (nominal-rate seconds)
    t_b: float     # client-side backward
    fc_bytes: float = 0.0   # uplink payload (0 = unknown, use t_fc)
    bc_bytes: float = 0.0   # downlink payload (0 = unknown, use t_bc)

    @property
    def ready(self) -> float:
        return self.t_f + self.t_fc

    def total(self, t_w: float) -> float:
        return self.t_f + self.t_fc + t_w + self.t_s + self.t_bc + self.t_b


def activation_bytes(cfg: ModelConfig, batch: int, seq_len: int,
                     dtype_bytes: Optional[int] = None) -> float:
    """Cut-activation payload; element width follows ``cfg.dtype`` unless
    overridden (bf16 halves the wireless bytes vs the old fp32 constant)."""
    if dtype_bytes is None:
        dtype_bytes = dtype_nbytes(cfg.dtype)
    return float(batch) * seq_len * cfg.d_model * dtype_bytes


def client_step_times(cfg: ModelConfig, cut: int, device: DeviceProfile,
                      server: DeviceProfile, link: LinkProfile,
                      batch: int, seq_len: int,
                      dtype_bytes: Optional[int] = None,
                      lora_rank: Optional[int] = None) -> StepTimes:
    """Eq. 10 terms for client u with N_c^u = cut layers.  ``lora_rank``
    overrides the config's adapter rank (the control plane evaluates
    candidate per-client ranks through here)."""
    tokens = float(batch) * seq_len
    lf = layer_fwd_flops_per_token(cfg, seq_len) \
        + lora_flops_per_token_per_layer(cfg, rank=lora_rank)
    n_total = cfg.n_layers + cfg.n_encoder_layers if cfg.family == "encdec" else cfg.n_layers
    n_server = n_total - cut

    c_flops = tokens * (lf * cut)                          # embed fwd negligible
    s_flops = tokens * (lf * n_server + head_fwd_flops_per_token(cfg))
    act = activation_bytes(cfg, batch, seq_len, dtype_bytes)

    t_f = c_flops / (device.tflops * 1e12 * device.utilization)
    t_b = BWD_FACTOR * t_f
    t_s = (1.0 + BWD_FACTOR) * s_flops / (server.tflops * 1e12 * server.utilization)
    return StepTimes(t_f=t_f, t_fc=link.transfer_s(act), t_s=t_s,
                     t_bc=link.transfer_s(act), t_b=t_b,
                     fc_bytes=act, bc_bytes=act)


def lora_upload_bytes(cfg: ModelConfig, cut: int, dtype_bytes: int = 4,
                      rank: Optional[int] = None) -> float:
    """Client-side adapter upload per aggregation round (Eq. 5 upload)."""
    r = cfg.lora.rank if rank is None else int(rank)
    per_layer = 0.0
    d = cfg.d_model
    for _ in cfg.lora.targets:
        per_layer += r * 2 * d * dtype_bytes
    return per_layer * cut


def migration_bytes(cfg: ModelConfig, old_cut: int, new_cut: int,
                    dtype_bytes: int = 4,
                    rank: Optional[int] = None) -> Tuple[float, float]:
    """Wire bytes to MOVE a client's cut point at a commit boundary.

    Growing the client prefix ships the extra frozen block weights plus
    their adapters DOWN to the client; shrinking ships the dropped blocks'
    adapter state UP (the frozen weights already live in the server's full
    model, so nothing heavy travels).  Returns ``(down_bytes, up_bytes)``
    — the control plane charges these through the network plane before
    accepting a re-assignment.
    """
    delta = int(new_cut) - int(old_cut)
    per_layer_adapters = lora_upload_bytes(cfg, 1, dtype_bytes, rank=rank)
    if delta > 0:
        per_layer_weights = layer_param_count(cfg) * dtype_bytes
        return (delta * (per_layer_weights + per_layer_adapters), 0.0)
    return (0.0, -delta * per_layer_adapters)


def chunked_service_time(service_times: Sequence[float],
                         efficiency: float = 1.0) -> float:
    """Server time for one cohort chunk.  A single client is the sequential
    baseline (exactly its t_s); a k>1 chunk runs as ONE batched vmapped
    dispatch whose FLOPs still add up, discounted by ``efficiency`` (the
    measured batching win — fewer dispatches, fuller kernels)."""
    if not 0.0 < efficiency <= 1.0:
        raise ValueError("efficiency must be in (0, 1]")
    ts = list(service_times)
    if len(ts) <= 1:
        return float(sum(ts))
    return float(efficiency * sum(ts))


def makespan(times: Sequence[StepTimes], order: Sequence[int]):
    """Pipeline semantics of Eqs. 10-12: the server is a single sequential
    resource; client u's job becomes available at ready_u; completion is
    server finish + grad download + client backward.  Returns
    (step_time, per-client completion list, per-client T^w list)."""
    t_server = 0.0
    completion = [0.0] * len(times)
    waits = [0.0] * len(times)
    for u in order:
        st = times[u]
        start = max(t_server, st.ready)
        waits[u] = start - st.ready
        t_server = start + st.t_s
        completion[u] = t_server + st.t_bc + st.t_b
    return max(completion), completion, waits
