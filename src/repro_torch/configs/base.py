"""Config dataclasses: the LLM architectures (``ModelConfig`` with its
SSM and MoE parts), the paper's CNN families, the wireless channel, the
compression schedule and the PFELS hyper-parameters.

A copy of the reference's ``repro/configs/base.py`` (same fields,
defaults and validation), kept here so the port imports nothing of the
JAX package; comments that name ``repro.*`` modules describe the
reference's registries, of which the port carries the entries its slice
runs. Configs are plain frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # experts are padded up to a multiple of the `model` mesh axis for
    # expert-parallel sharding; routing masks the pads.
    padded_experts: Optional[int] = None

    def experts_padded(self, model_axis: int) -> int:
        if self.padded_experts is not None:
            return self.padded_experts
        e = self.num_experts
        return ((e + model_axis - 1) // model_axis) * model_axis


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128            # N (SSD state size)
    head_dim: int = 64              # P per-head channel dim
    num_heads: Optional[int] = None  # derived: d_inner / head_dim if None
    expand: int = 2                 # d_inner = expand * d_model
    chunk_size: int = 128           # SSD chunk length (MXU-aligned)
    conv_width: int = 4             # short causal conv width
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    """One transformer-family architecture.

    ``block_pattern`` is a tuple of block kinds, repeated ``n_repeat`` times to
    form the full stack; stacked params are scanned with ``lax.scan``.
    Block kinds: "attn" (attention + dense MLP), "moe" (attention + MoE MLP),
    "mamba" (Mamba2 SSD block), "attn_only", "mlp_only".
    """
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    n_repeat: Optional[int] = None  # default n_layers // len(block_pattern)
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False             # M-RoPE (qwen2-vl): 3-D t/h/w position ids
    sliding_window: Optional[int] = None   # if set, training attn is windowed
    long_context_window: int = 8192        # window used for long_500k decode
    mlp_act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    attn_block_kv: int = 512        # flash-attention KV block (perf knob)
    # "f32": norm computed fully in f32 (cotangents become f32 -> f32
    # backward all-reduces); "stats_f32": only the statistics in f32, the
    # scaling applied in the input dtype (bf16 cotangents; perf knob)
    norm_impl: str = "f32"
    # "2d": fsdp(data) x tensor(model); "fsdp": pure FSDP over data x model
    # (tensor parallelism off — wins when activations >> params, §Perf)
    parallelism: str = "2d"
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper): encoder consumes stub frame embeddings
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500         # stub frontend frames
    # vlm: stub vision prefix of patch embeddings
    vision_prefix: int = 0          # #patch-embedding tokens prepended
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # provenance
    source: str = ""

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def resolved_repeat(self) -> int:
        if self.n_repeat is not None:
            return self.n_repeat
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern {self.block_pattern}")
        return self.n_layers // len(self.block_pattern)

    def with_reduced(self, **kw) -> "ModelConfig":
        """A reduced variant of the same family for CPU smoke tests."""
        return dataclasses.replace(self, **kw)

    def param_count_estimate(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS and for
        PFELS dimension d); exact counts come from the built pytree."""
        hd = self.resolved_head_dim()
        d = self.d_model
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp_dense = 3 * d * self.d_ff if self.mlp_act == "swiglu" else 2 * d * self.d_ff
        total = 0
        rep = self.resolved_repeat()
        for kind in self.block_pattern:
            if kind == "attn":
                total += attn + mlp_dense
            elif kind == "moe":
                assert self.moe is not None
                e = self.moe.num_experts
                total += attn + e * 3 * d * self.moe.expert_ff + d * e
            elif kind == "mamba":
                assert self.ssm is not None
                dinner = self.ssm.expand * d
                nh = self.ssm.num_heads or dinner // self.ssm.head_dim
                # in_proj (z,x,B,C,dt) + out_proj + conv
                total += d * (2 * dinner + 2 * self.ssm.state_dim + nh) \
                    + dinner * d + self.ssm.conv_width * dinner
        total *= rep
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            enc = (attn + mlp_dense) * self.n_encoder_layers
            dec_cross = (attn) * self.n_layers     # cross-attn blocks
            total += enc + dec_cross
        return total

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count_estimate()
        full = self.param_count_estimate()
        d, e, k = self.d_model, self.moe.num_experts, self.moe.top_k
        rep = self.resolved_repeat() * sum(1 for b in self.block_pattern if b == "moe")
        expert_params = rep * e * 3 * d * self.moe.expert_ff
        active_expert = rep * k * 3 * d * self.moe.expert_ff
        return full - expert_params + active_expert



@dataclass(frozen=True)
class CNNConfig:
    """Paper's own model families (VGG-11 on CIFAR-10, ResNet-18 on FEMNIST),
    reduced-scale capable for CPU reproduction."""
    name: str
    arch: str                        # "vgg" | "resnet" | "mlp"
    in_channels: int = 3
    image_size: int = 32
    num_classes: int = 10
    width_mult: float = 1.0
    source: str = ""


@dataclass(frozen=True)
class ChannelConfig:
    """Wireless channel scenario (paper §8.1 + the DESIGN.md §11 registry).

    ``model`` selects a registered :mod:`repro.core.channels` entry —
    ``block_fading`` is the paper's flat block-fading MAC (the default and
    the bit-exact seed behavior); ``markov_fading`` correlates gains across
    rounds (Gauss–Markov copula, ``markov_rho``); ``mimo_mrc`` gives the
    base station ``num_antennas`` receive antennas with maximum-ratio
    combining; ``dropout`` wraps ``dropout_base`` and zeroes a
    Bernoulli(``dropout_prob``) subset of the cohort's transmissions.
    Model-specific fields are ignored by models that don't read them.
    """
    gain_mean: float = 0.02           # |h| ~ Exp(mean)
    gain_clip: Tuple[float, float] = (1e-4, 0.1)
    noise_std: float = 1.0            # sigma_0
    snr_db_range: Tuple[float, float] = (2.0, 15.0)  # per-device max SNR
    # imperfect CSI (beyond paper — the paper defers this to future work):
    # clients precompensate with h_est = h * (1 + eps), eps ~ N(0, csi_err^2)
    csi_error: float = 0.0
    # --- scenario selection (DESIGN.md §11) ---
    model: str = "block_fading"       # repro.core.channels registry key
    markov_rho: float = 0.9           # AR(1) round-to-round gain correlation
    num_antennas: int = 4             # M receive antennas (mimo_mrc)
    dropout_prob: float = 0.1         # P(client drops its transmission)
    dropout_base: str = "block_fading"  # model the dropout wrapper fades by

    def __post_init__(self):
        """Reject silently-NaN configurations up front: a swapped
        ``gain_clip`` used to clamp every gain to the lower bound and feed
        a nonsensical β design; a non-positive ``noise_std`` makes C2 (and
        the ε ledger) undefined."""
        lo, hi = self.gain_clip
        if not (0.0 < lo < hi):
            raise ValueError(
                f"gain_clip must satisfy 0 < lo < hi, got {self.gain_clip}")
        if self.gain_mean <= 0.0:
            raise ValueError(f"gain_mean must be > 0, got {self.gain_mean}")
        if self.noise_std <= 0.0:
            raise ValueError(
                f"noise_std (sigma_0) must be > 0, got {self.noise_std}")
        s_lo, s_hi = self.snr_db_range
        if not s_lo < s_hi:
            raise ValueError(
                f"snr_db_range must be ordered (lo < hi), got "
                f"{self.snr_db_range}")
        if self.csi_error < 0.0:
            raise ValueError(
                f"csi_error must be >= 0, got {self.csi_error}")
        if not self.model or not isinstance(self.model, str):
            raise ValueError(f"model must be a registry name, got "
                             f"{self.model!r}")
        if not 0.0 <= self.markov_rho < 1.0:
            raise ValueError(
                f"markov_rho must be in [0, 1), got {self.markov_rho}")
        if self.num_antennas < 1:
            raise ValueError(
                f"num_antennas must be >= 1, got {self.num_antennas}")
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError(
                f"dropout_prob must be in [0, 1), got {self.dropout_prob}")
        if self.dropout_base == "dropout":
            raise ValueError("dropout_base cannot be 'dropout' (no "
                             "self-nesting); pick a fading model")


@dataclass(frozen=True)
class CompressionSchedule:
    """DP-aware adaptive compression schedule (DESIGN.md §13).

    Declarative policy; ``repro.core.compressors.schedules`` evaluates it
    trace-safely inside the compiled scan from the round counter and the
    ledger's running ε spend (``Trainer.run`` stays zero-host-round-trip).

    ``mode``: "none" (the seed-exact default — every knob untouched),
    "linear" (k budget and transmit power annealed linearly over
    ``cfg.rounds``), or "budget" (same anneals, plus the per-round ε
    ceiling becomes the remaining total budget ``cfg.epsilon·cfg.rounds``
    spread over the rounds left, floored at ``eps_floor`` and never above
    ``cfg.epsilon``). ``k_end_ratio``: final live fraction of the k
    budget at round T (1.0 = no k anneal). ``power_end``: final P_i
    multiplier at round T (1.0 = no power anneal).
    """
    mode: str = "none"            # none | linear | budget
    k_end_ratio: float = 1.0      # final live k fraction at round T
    power_end: float = 1.0        # final power-limit multiplier at T
    eps_floor: float = 0.0        # budget mode: per-round eps floor

    def __post_init__(self):
        if self.mode not in ("none", "linear", "budget"):
            raise ValueError(
                f"schedule mode must be none|linear|budget, got "
                f"{self.mode!r}")
        if not 0.0 < self.k_end_ratio <= 1.0:
            raise ValueError(
                f"k_end_ratio must be in (0, 1], got {self.k_end_ratio}")
        if not 0.0 < self.power_end <= 1.0:
            raise ValueError(
                f"power_end must be in (0, 1] (anneal down), got "
                f"{self.power_end}")
        if self.eps_floor < 0.0:
            raise ValueError(
                f"eps_floor must be >= 0, got {self.eps_floor}")


@dataclass(frozen=True)
class PFELSConfig:
    """Algorithm 2 hyper-parameters."""
    num_clients: int = 1000           # N
    clients_per_round: int = 32       # r
    local_steps: int = 5              # tau (paper uses tau epochs; we expose steps)
    local_lr: float = 0.05            # eta
    clip: float = 1.0                 # C1 (per-step gradient clip)
    compression_ratio: float = 0.3    # p = k/d
    epsilon: float = 1.5              # per-round privacy budget
    delta: Optional[float] = None     # default 1/N
    rounds: int = 2000                # T
    momentum: float = 0.9
    algorithm: str = "pfels"          # pfels | wfl_p | wfl_pdp | dp_fedavg | fedavg
    unbiased_rescale: bool = False    # beyond-paper: multiply update by d/k
    error_feedback: bool = False      # beyond-paper: error compensation [28-30]
    dp_fedavg_sigma: float = 1.0      # noise multiplier for DP-FedAvg baseline
    # exact | mask (seeded Bernoulli(p)) | server_topk (beyond paper:
    # omega_t = top-k coords of |Delta_hat_{t-1}| — server-guided, keeps
    # the shared-subcarrier alignment AirComp requires)
    randk_mode: str = "exact"
    grad_accum: int = 1               # microbatches per step (memory knob)
    # fused transmit pipeline, the default: AirComp aggregation runs
    # through the pfels_transmit CUDA kernels (clip pass, then mask ->
    # power scale -> MAC sum -> noise -> energy in one pass over d, no
    # (r, d) intermediates). False runs the unfused plain-torch path.
    use_fused_kernel: bool = True
    # optional transmit-side per-client l2 cap C: each Delta_i is scaled by
    # min(1, C/||Delta_i||) before sparsification, enforcing the Theorem-5
    # premise ||Delta|| <= eta tau C1. None disables.
    transmit_clip: Optional[float] = None
    # sharded cohort execution (DESIGN.md §7): "cohort" runs the per-client
    # pipeline under shard_map with the r selected clients partitioned over
    # the ("pod", "data") mesh axes and the AirComp sum as a cross-device
    # psum; "none" keeps the vmapped single-device path. The cohort mode
    # drops back to the vmapped path whenever the mesh's client extent is 1
    # or does not divide clients_per_round (graceful replication).
    client_sharding: str = "none"     # none | cohort
    # ClientBank backend (DESIGN.md §10): "resident" keeps all per-client
    # state (EF residuals, PRNG lanes, participation counts) as dense
    # device arrays carried through the scan — bit-identical to the
    # pre-bank behavior. "streamed" keeps the bank host-side and moves
    # only the sampled r-client cohort on/off device each round, so
    # device memory is independent of num_clients (the population-scale
    # path; benchmarks/population_scale.py runs 100_000 clients).
    bank_backend: str = "resident"    # resident | streamed
    # update-compression scheme (DESIGN.md §13): a repro.core.compressors
    # registry key. "rand_k" is the paper's uniform draw (seed-exact);
    # "top_k_ef" transmits the top coords of the released aggregate with
    # mandatory error feedback; "threshold" hard-thresholds against
    # threshold_frac * max|prev_delta| (static-width padded, live slots
    # via Support.active); "stoch_quant" adds quant_bits-level unbiased
    # stochastic quantization over rand-k with its own sensitivity bound.
    # Consumed only by sparsifying AirComp algorithms (pfels).
    compressor: str = "rand_k"
    quant_bits: int = 8               # stoch_quant magnitude levels 2^(b-1)-1
    threshold_frac: float = 0.1       # threshold: fraction of max|prev_delta|
    # adaptive k / power / per-round-eps schedule (DESIGN.md §13);
    # mode="none" is the seed-exact static default
    schedule: CompressionSchedule = field(
        default_factory=CompressionSchedule)
    channel: ChannelConfig = field(default_factory=ChannelConfig)

    def resolved_delta(self) -> float:
        return self.delta if self.delta is not None else 1.0 / self.num_clients
