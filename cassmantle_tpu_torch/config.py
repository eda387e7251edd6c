"""Typed configuration for the PyTorch/CUDA port.

A copy of the part of ``cassmantle_tpu/config.py`` that the port reads:
the SD1.5 and SDXL model zoos (CLIP text towers, UNet, VAE), GPT-2 or
Mistral-7B for the round's prompt text, MiniLM for guess scoring, the
sampler and text decode settings, speculative decode, the serving
seam's bounds, the observability and SLO settings, the game's constants,
the room fabric's and the fault-injection plan's, and the device mesh's
axes (:class:`MeshConfig`, ``parallel/mesh.py``). Defaults are
the reference's defaults, so ``FrameworkConfig()`` is the serving
configuration: SD1.5 at 512², 50 DDIM steps, CFG 7.5; :func:`sdxl_config`
is SDXL-base at 1024².

The port keeps its own copy (it imports nothing of the JAX package);
fields no port module reads yet are left out. The fused-conv and W8A8
serving presets (:func:`fusedconv_serving_config`,
:func:`w8a8_serving_config`) change how the UNet's and GPT-2's hot sites
execute, not the parameter tree; :func:`encprop_serving_config` and
:func:`deepcache_serving_config` change which UNet forwards the DDIM loop
runs (and the first runs the VAE decoder on the fused conv);
:func:`fast_serving_config`, :func:`turbo_serving_config` and
:func:`lcm_serving_config` serve the other samplers (DPM-Solver++(2M),
with DeepCache pairs, and four consistency steps);
:func:`spec_decode_serving_config` decodes the prompt text by draft and
verify, to the same tokens. The reference has no Mistral preset: a
config sets ``models.mistral = MistralConfig()``, as its server's
``--lm mistral`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from cassmantle_tpu_torch.utils.logging import (
    DEFAULT_BUCKETS_S as _DEFAULT_BUCKETS_S,
)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    """SD1.5's text tower (OpenAI CLIP ViT-L/14 text model) dimensions."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    # ViT-L/14 was trained with quick_gelu; OpenCLIP bigG with exact gelu.
    hidden_act: str = "quick_gelu"

    @staticmethod
    def sdxl_big() -> "ClipTextConfig":
        """SDXL's second text tower (OpenCLIP ViT-bigG): the same module
        at other dimensions."""
        return ClipTextConfig(
            vocab_size=49408,
            hidden_size=1280,
            intermediate_size=5120,
            num_layers=32,
            num_heads=20,
            max_positions=77,
            hidden_act="gelu",
        )


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Diffusion UNet. Defaults = SD1.5; ``sdxl()`` = SDXL-base geometry."""

    sample_channels: int = 4
    base_channels: int = 320
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    # Per level: whether the level's resnet blocks carry transformer
    # (self + cross attention) blocks, and how many.
    attention_levels: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    blocks_per_level: int = 2
    # None: heads = channels // 64 (the SDXL convention).
    num_heads: Optional[int] = 8
    context_dim: int = 768
    time_embed_dim: int = 1280
    # SDXL micro-conditioning (added time-embedding channels); 0 disables.
    addition_embed_dim: int = 0
    dtype: str = "bfloat16"
    # Every ResBlock's GroupNorm -> SiLU -> conv3x3 runs as one fused
    # kernel (ops/fused_conv.py): the activated tensor never reaches
    # device memory. Same parameters and outputs (up to rounding) as the
    # unfused path; CASSMANTLE_NO_FUSED_CONV=1 selects the unfused path.
    fused_conv: bool = False
    # The TPU path's channel padding to full 128-lane tiles. The CUDA
    # kernels tile for Hopper and ignore it; the plain versions apply it,
    # so the tests show that it changes nothing.
    conv_pad_to: int = 0

    def arch(self) -> "UNetConfig":
        """This config with the execution-strategy flags cleared: the
        architecture (parameter tree and numerics) alone."""
        return dataclasses.replace(self, fused_conv=False, conv_pad_to=0)

    @staticmethod
    def sdxl() -> "UNetConfig":
        return UNetConfig(
            base_channels=320,
            channel_mults=(1, 2, 4),
            attention_levels=(False, True, True),
            transformer_depth=(0, 2, 10),
            num_heads=None,  # head dim 64: heads = channels // 64
            context_dim=2048,
            time_embed_dim=1280,
            addition_embed_dim=2816,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD autoencoder; the decoder is the serving path."""

    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    scaling_factor: float = 0.18215  # SD1.5; SDXL uses 0.13025
    dtype: str = "bfloat16"
    # Every decoder ResBlock's GroupNorm -> SiLU -> conv3x3 as one fused
    # kernel, as ``UNetConfig.fused_conv`` (the same kernel, at widths
    # 64-512 at SD1.5); the decoder then runs channels-last. Same
    # parameters; CASSMANTLE_NO_FUSED_CONV=1 selects the unfused path.
    fused_conv: bool = False

    def arch(self) -> "VAEConfig":
        """This config with the execution-strategy flag cleared."""
        return dataclasses.replace(self, fused_conv=False)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2-small for the round's prompt text (greedy decode)."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 1024
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class MistralConfig:
    """Mistral-7B-Instruct-class causal LM, the reference game's own prompt
    model: RoPE positions, grouped-query attention (8 KV heads), a
    sliding attention window, RMSNorm and a SwiGLU MLP. Defaults are the
    7B geometry; ``tiny()`` is the CPU-test variant."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_positions: int = 4096
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"

    @staticmethod
    def tiny() -> "MistralConfig":
        return MistralConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_positions=64, sliding_window=16, dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class MiniLMConfig:
    """all-MiniLM-L6-v2-class sentence encoder for guess scoring."""

    vocab_size: int = 30522
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 6
    num_heads: int = 12
    max_positions: int = 512
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelZooConfig:
    clip_text: ClipTextConfig = dataclasses.field(default_factory=ClipTextConfig)
    # SDXL's second text tower (OpenCLIP bigG); None for SD1.5.
    clip_text_2: Optional[ClipTextConfig] = None
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    gpt2: GPT2Config = dataclasses.field(default_factory=GPT2Config)
    # The prompt LM is Mistral-7B-class when set, else GPT-2.
    mistral: Optional[MistralConfig] = None
    minilm: MiniLMConfig = dataclasses.field(default_factory=MiniLMConfig)
    # Storage dtype of the UNet, CLIP and prompt-LM parameters (the VAE and
    # MiniLM keep fp32 storage, as in the reference). Each layer casts
    # its parameters to its compute dtype where it uses them.
    param_dtype: str = "bfloat16"
    # Weights-only int8 (w8a16) of the prompt LM and of the UNet in the
    # reference. Not ported: PromptGenerator and w8a8_unet_tools refuse
    # them (the UNet's with the reference's exclusivity error: both
    # rewrite the same weights).
    lm_int8: bool = False
    unet_int8: bool = False
    # W8A8 serving (ops/quant.py, ops/quant_matmul.py): int8 weights and
    # activations at every attention, GEGLU and ResBlock-conv site of the
    # UNet (needs unet.fused_conv), and at every GPT-2 projection with
    # per-token activation scales. Weights quantize once, at build;
    # CASSMANTLE_NO_W8A8=1 (read at build) never quantizes.
    unet_w8a8: bool = False
    lm_w8a8: bool = False
    # Smallest weight (in elements) that W8A8 quantizes; the tests drop
    # it to 0 so the tiny geometry reaches the int8 path.
    w8a8_min_size: int = 1 << 16


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Image sampler and greedy text decode settings. ``kind``: "ddim",
    "euler" or "dpmpp_2m" (ops/samplers.py); ``eta`` > 0 (DDIM only) is
    refused by the pipelines, as the reference's draw no step key."""

    kind: str = "ddim"
    num_steps: int = 50
    guidance_scale: float = 7.5
    eta: float = 0.0
    image_size: int = 512
    # CFG negative conditioning; "" is the plain unconditional arm.
    negative_prompt: str = "blurry, distorted, fake, abstract, negative"
    # Deep-feature reuse (DeepCache): steps run in full/shallow pairs,
    # the shallow pass (level 0 only) reusing the full pass's deep
    # activation. DDIM at eta 0 with even num_steps, or DPM++(2M) (an odd
    # count ends on an unpaired full step).
    deepcache: bool = False
    # Encoder propagation (Faster Diffusion): full UNet forwards only at
    # the key steps (the first ``encprop_dense_steps``, then every
    # ``encprop_stride``-th); the steps between run the decoder alone
    # against the key step's skip stack and mid-block output, batched
    # per segment. Composes with ``deepcache`` (the second step of a
    # segment then runs shallow). Every sampler kind at eta 0;
    # CASSMANTLE_NO_ENCPROP=1 serves full forwards at every step.
    encprop: bool = False
    encprop_stride: int = 3
    encprop_dense_steps: int = 5
    # Few-step consistency serving (ops/samplers.py): ``num_steps`` (1-8)
    # direct x0 predictions through the boundary parameterization, on the
    # grid of ``consistency_teacher_steps``. Not with deepcache or
    # encprop; CASSMANTLE_NO_CONSISTENCY=1 (read at build) serves the
    # teacher path instead: ``kind`` at ``consistency_teacher_steps``.
    consistency: bool = False
    # The deployed UNet IS a consistency-distilled student, though
    # serving defaults to the teacher schedule: the signal that lets the
    # brownout ladder's few-step tier step INTO consistency sampling
    # (serving/overload.py). An undistilled UNet leaves it False, and
    # the ladder falls through to the resolution tier instead.
    consistency_available: bool = False
    consistency_teacher_steps: int = 50
    min_new_tokens: int = 32
    max_new_tokens: int = 96
    prompt_pad_len: int = 77
    # 0 is greedy decode (the reference's decode mode); above 0, top-k
    # sampling: a categorical draw over the ``text_top_k`` largest logits
    # divided by the temperature.
    text_temperature: float = 0.0
    text_top_k: int = 40


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Speculative decode of the prompt text (``ops/decode.py``
    ``speculative_decode``): a draft proposes ``gamma`` tokens and the
    target scores all gamma+1 positions in one ``decode_chunk`` forward.
    Serves only greedy decodes (temperature 0), where acceptance is an
    exact argmax match and the tokens are greedy decode's;
    ``CASSMANTLE_NO_SPEC_DECODE=1`` turns it off."""

    # "off" | "ngram" (prompt lookup: the continuation of the latest
    # earlier match of the last ``ngram`` tokens) | "draft_model" (a
    # smaller GPT-2 with its own cache)
    mode: str = "off"
    gamma: int = 4
    ngram: int = 3
    # the "draft_model" draft: a GPT-2 config with the target's vocabulary;
    # equal to the target's GPT-2 config, the target drafts for itself
    draft_model: Optional[GPT2Config] = None


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The serving seam's bounds, at the reference's defaults
    (``cassmantle_tpu/config.py::ServingConfig``)."""

    # Padded batch buckets of the scorer's device encode; 2048 covers the
    # guesses and answers of 1k pairs in one dispatch.
    score_batch_sizes: Tuple[int, ...] = (8, 64, 256, 1024, 2048)
    # The batching queues (serving/queue.py): the coalescing window and
    # the static bound on pending submissions.
    max_queue_delay_ms: float = 25.0
    max_pending: int = 4096
    # Per-request deadline (None: none): bounds a wedged dispatch, sized
    # for a cold first call (kernel builds, graph captures); not a
    # latency target.
    submit_deadline_s: Optional[float] = 300.0
    # Dispatch watchdog: a handler running longer has wedged the dispatch
    # thread, which is disowned and replaced (None: off).
    dispatch_hang_s: Optional[float] = 300.0
    # The pending bound while the supervisor reports degraded.
    degraded_max_pending: int = 256
    # Adaptive (AIMD) admission (serving/overload.py): the latency target
    # of queue wait + batch service, and the floor of the limit;
    # CASSMANTLE_NO_ADAPTIVE_ADMISSION=1 reverts to the static bounds.
    queue_latency_target_s: float = 1.0
    admission_min_pending: int = 8
    # Background work (round generation) sheds at this fraction of the
    # limit, first under pressure.
    admission_background_fraction: float = 0.5
    # Starvation bound: after this many consecutive batches dispatched
    # with background work pending, the oldest background item heads the
    # next batch.
    background_every_batches: int = 8
    # Event-loop lag (the server.loop_lag_s gauge) above which background
    # submissions shed; interactive ones shed at 4x.
    loop_lag_shed_s: float = 0.25
    # The SLO-driven brownout ladder (serving/overload.py): the dwell
    # before stepping UP a quality tier on sustained fast-window burn,
    # and (the hysteresis) before stepping DOWN after the slow window
    # recovers. CASSMANTLE_NO_BROWNOUT=1 pins tier 0.
    brownout_step_up_dwell_s: float = 10.0
    brownout_step_down_dwell_s: float = 30.0
    # The SLO objectives the ladder watches (obs/slo.py names);
    # replication lag is absent: quality tiers cannot fix a store.
    brownout_objectives: Tuple[str, ...] = ("score_latency",
                                            "round_generation")
    # A --fake worker's stand-in for the device's scoring cost: > 0 puts
    # the hash scorer behind a real BatchingQueue whose handler holds the
    # dispatch thread this long a batch (serving/fake_scorer.py); 0 keeps
    # the instant hash scorer.
    fake_score_batch_ms: float = 0.0
    # Stage-disaggregated image serving (serving/stages.py): encode,
    # denoise and decode as independently batched stages, the denoise
    # stage admitting and retiring requests at step boundaries over a
    # fixed slot tensor, so a request arriving mid-denoise of another
    # starts at the next step instead of waiting a whole image.
    # CASSMANTLE_NO_STAGED_SERVING=1 is the kill switch; configs the slot
    # stepper cannot replay (DeepCache, encprop, eta > 0) stay monolithic.
    staged_serving: bool = False
    # The denoise stage's slot capacity; a step gathers the live slots
    # into the smallest width >= occupancy (powers of two up to the
    # capacity, and the capacity), one captured graph per width.
    denoise_slots: int = 4
    # The encode and decode stages' batch buckets (a batch pads to the
    # next one).
    stage_encode_batch_sizes: Tuple[int, ...] = (1, 2, 4, 8)
    stage_decode_batch_sizes: Tuple[int, ...] = (1, 2, 4)
    # The encode and decode stages' coalescing window: short, since the
    # denoise stage's step-boundary admission does the real batching.
    stage_max_delay_ms: float = 3.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh (``cassmantle_tpu/config.py::MeshConfig``).
    Axes follow the scaling-book convention:

    - ``dp``: data parallel (batch sharding);
    - ``tp``: tensor parallel (attention heads / MLP columns);
    - ``sp``: sequence/spatial parallel (latent rows, image tokens);
    - ``pp``: pipeline parallel (layer stages);
    - ``ep``: expert parallel (MoE experts).
    Sizes of -1 mean "fill with the remaining devices". The port serves
    over ``dp`` and ``sp`` (``serving/pipeline.py``,
    ``parallel/spatial.py``); ``tp``, ``pp`` and ``ep`` are training's
    axes, not ported yet (ROADMAP Queue 1 item 16)."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    # Axis names, in mesh order.
    axis_names: Tuple[str, ...] = ("dp", "pp", "tp", "sp", "ep")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (obs/, utils/logging.py) and the SLO burn-rate
    engine's settings (obs/slo.py), at the reference's defaults; the
    server applies them through ``obs.configure_observability``."""

    # Healthy-baseline sampling floor: the fraction of root spans kept
    # unconditionally. Every other trace waits in the pending ring and is
    # kept only when its root ends slow, errored or marked
    # (CASSMANTLE_NO_TAIL_SAMPLING=1: the coin alone decides).
    trace_sample_rate: float = 1.0
    # Traces /debugz?trace= can answer (LRU), and spans a trace keeps.
    trace_capacity: int = 256
    trace_max_spans: int = 512
    # The pending ring: its bound, and the age past which a trace whose
    # root never ended is dropped (obs.traces_abandoned).
    trace_pending_capacity: int = 512
    trace_pending_ttl_s: float = 120.0
    # Tail retention: a root span at least this slow is kept; per route
    # by root span name ("http.post /compute_score").
    tail_slow_default_s: float = 1.0
    tail_slow_routes: Tuple[Tuple[str, float], ...] = ()
    # Events /debugz replays from the flight recorder.
    recorder_capacity: int = 512
    # Per-peer timeout of the cluster fan-outs (/metrics?scope=cluster,
    # /debugz?trace=&scope=cluster, the scorer hedge): a dark peer costs
    # at most this and is marked.
    cluster_fanout_timeout_s: float = 2.0
    # Latency histograms' default bounds (seconds).
    latency_buckets_s: Tuple[float, ...] = _DEFAULT_BUCKETS_S
    # Cadence of the process and device samplers (obs/process.py,
    # obs/device.py).
    process_sample_interval_s: float = 5.0
    # Evaluation cadence of the server's background SLO loop
    # (server/app.py ``_slo_loop``; CASSMANTLE_NO_SLO=1 turns it off).
    slo_eval_interval_s: float = 10.0
    # Multi-window burn rates: trip on the fast window, recover on the
    # slow one.
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    # Default objective thresholds: p99 bound of a scored guess, the
    # round-generation success ratio, the replication-lag bound.
    slo_score_p99_s: float = 2.0
    slo_generation_ratio: float = 0.9
    slo_repl_lag_max: float = 512.0
    # The canary prober (obs/prober.py): the cadence of its loop and each
    # leg's HTTP timeout. CASSMANTLE_NO_PROBER=1 turns it off;
    # CASSMANTLE_PROBE_INTERVAL_S overrides the cadence.
    probe_interval_s: float = 15.0
    probe_timeout_s: float = 5.0
    # The canary prober's objectives: success ratio and p99 bound.
    probe_success_ratio: float = 0.95
    probe_p99_s: float = 3.0


@dataclasses.dataclass(frozen=True)
class GameConfig:
    """Round and game constants (engine/game.py), at the reference's
    defaults."""

    min_score: float = 0.01
    # Seconds a round is current before the buffered one is promoted.
    time_per_prompt: float = 900.0
    # Fraction of a round after which the next one is buffered.
    buffer_at_fraction: float = 0.7
    # Masked words per round: generated text needs at least this many
    # words plus one, or the round falls back to template text.
    num_masked: int = 2
    episodes_per_story: int = 20
    min_blur: float = 0.0
    max_blur: float = 15.0
    # The store lock's lease and how long a caller waits to take it.
    lock_timeout: float = 120.0
    acquire_timeout: float = 2.0
    # Token-bucket rates per (client IP, room): requests a second on most
    # routes, and on the API routes (server/ratelimit.py).
    rate_limit_default: float = 3.0
    rate_limit_api: float = 2.0
    # Round-reserve ring (engine/reserve.py): archived rounds rotated in
    # while generation is dark. 0 disables.
    reserve_capacity: int = 8


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """The room fabric (fabric/): rooms over one store, placed across the
    workers that share it. One worker with one room (the defaults) is the
    classic game; the default room lives at the store's un-prefixed
    keys."""

    # Rooms, each with its own clock, content and scores: ``default_room``
    # and room-1 .. room-(N-1); sessions hash onto them.
    num_rooms: int = 1
    default_room: str = "lobby"
    # Stable worker identity ("" derives host:pid;
    # CASSMANTLE_ROOM_WORKER_ID overrides).
    worker_id: str = ""
    # The address peers redirect this worker's rooms to ("": none;
    # CASSMANTLE_ROOM_ADVERTISE overrides).
    advertise_addr: str = ""
    # Membership heartbeat cadence, and the age past which a worker's
    # heartbeat reads as dead.
    heartbeat_s: float = 2.0
    membership_ttl_s: float = 6.0
    # Virtual nodes per worker on the placement ring.
    vnodes: int = 64
    # A replicated store's endpoints ("host:port", ...;
    # CASSMANTLE_REPL_ENDPOINTS overrides), its pump's poll and the leader
    # lease, the failover's detection time (CASSMANTLE_REPL_POLL_MS and
    # CASSMANTLE_REPL_LEASE_MS override).
    repl_endpoints: Tuple[str, ...] = ()
    repl_poll_s: float = 0.05
    repl_lease_s: float = 3.0
    # The graceful handoff's wait for every live peer to heartbeat past
    # this worker's departure, i.e. adopt its rooms.
    handoff_grace_s: float = 5.0


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault injection (chaos/): ``spec`` in the ``CASSMANTLE_CHAOS``
    grammar, which wins when both are set; empty is disarmed. ``seed`` is
    the plan's seed when the spec names none."""

    spec: str = ""
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class QualityGateConfig:
    """CLIP-parity thresholds a fast preset must clear before its speed
    counts (the reference's ``QualityGateConfig``). ``clip-report``
    enforces them when the report is a measurement (every CLIP stage and
    every pipeline loaded from checkpoints); on seeded weights they are
    advisory. Ratios are a preset's clip_sim_mean over the ddim50
    anchor's; a preset absent here is reported, not gated."""

    parity_vs_ddim50: Tuple[Tuple[str, float], ...] = (
        ("dpmpp25", 0.97),
        ("deepcache", 0.97),
        ("turbo", 0.95),
        ("int8", 0.98),
        ("encprop", 0.95),
        ("lcm", 0.90),
        ("w8a8", 0.98),
        ("sdxl_w8a8", 0.98),
    )
    # the anchor's own floor: a fault that lowers every preset alike
    # leaves the ratios passing
    ddim50_min_sim: float = 0.18

    def threshold_for(self, preset: str) -> Optional[float]:
        return dict(self.parity_vs_ddim50).get(preset)


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    models: ModelZooConfig = dataclasses.field(default_factory=ModelZooConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    game: GameConfig = dataclasses.field(default_factory=GameConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    fabric: FabricConfig = dataclasses.field(default_factory=FabricConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    spec_decode: SpecDecodeConfig = dataclasses.field(
        default_factory=SpecDecodeConfig)
    quality: QualityGateConfig = dataclasses.field(
        default_factory=QualityGateConfig)
    seed: int = 0

    def replace(self, **kw) -> "FrameworkConfig":
        return dataclasses.replace(self, **kw)


def sdxl_config() -> FrameworkConfig:
    """SDXL-base-1.0 at 1024x1024: dual text towers (CLIP-L + OpenCLIP
    bigG), micro-conditioned UNet, 0.13025 VAE scaling."""

    return FrameworkConfig(
        models=ModelZooConfig(
            clip_text=ClipTextConfig(),
            clip_text_2=ClipTextConfig.sdxl_big(),
            unet=UNetConfig.sdxl(),
            vae=VAEConfig(scaling_factor=0.13025),
        ),
        sampler=SamplerConfig(image_size=1024),
    )


def fusedconv_serving_config() -> FrameworkConfig:
    """DDIM-50 with every UNet ResBlock's GroupNorm -> SiLU -> conv3x3 as
    one fused kernel (and the reference's 128-channel padding flag)."""
    base = FrameworkConfig()
    return base.replace(models=dataclasses.replace(
        base.models, unet=dataclasses.replace(
            base.models.unet, fused_conv=True, conv_pad_to=128)))


def w8a8_serving_config() -> FrameworkConfig:
    """:func:`fusedconv_serving_config` served W8A8: int8 weights and
    activations at the UNet's attention, GEGLU and ResBlock-conv sites
    (dynamic per-tensor activation scales) and at GPT-2's projections
    (per-token scales)."""
    base = fusedconv_serving_config()
    return base.replace(models=dataclasses.replace(
        base.models, unet_w8a8=True, lm_w8a8=True))


def encprop_serving_config() -> FrameworkConfig:
    """DDIM-50 with encoder propagation (20 key forwards: 5 dense, then
    every 3rd; 30 decoder-only steps, batched per segment) and the VAE
    decoder's ResBlocks on the fused conv kernel."""
    base = FrameworkConfig()
    return base.replace(
        sampler=dataclasses.replace(base.sampler, encprop=True),
        models=dataclasses.replace(base.models, vae=dataclasses.replace(
            base.models.vae, fused_conv=True)))


def deepcache_serving_config() -> FrameworkConfig:
    """DDIM-50 with deep-feature reuse: 25 full/shallow step pairs."""
    return FrameworkConfig(sampler=SamplerConfig(deepcache=True))


def fast_serving_config() -> FrameworkConfig:
    """Low-latency serving: DPM-Solver++(2M) at 25 steps."""
    return FrameworkConfig(
        sampler=SamplerConfig(kind="dpmpp_2m", num_steps=25))


def turbo_serving_config() -> FrameworkConfig:
    """DPM-Solver++(2M) at 24 steps with DeepCache: 12 full/shallow
    pairs."""
    return FrameworkConfig(
        sampler=SamplerConfig(kind="dpmpp_2m", num_steps=24, deepcache=True))


def lcm_serving_config() -> FrameworkConfig:
    """Few-step serving: four consistency steps on the 50-step teacher
    grid (a consistency-distilled UNet's sampler);
    CASSMANTLE_NO_CONSISTENCY=1 reverts to the teacher's DDIM-50."""
    return FrameworkConfig(
        sampler=SamplerConfig(consistency=True, num_steps=4))


def spec_decode_serving_config() -> FrameworkConfig:
    """The default config with the prompt LM decoded speculatively by the
    n-gram prompt-lookup draft (gamma 4, suffix 3): the same tokens as
    greedy decode."""
    return FrameworkConfig(
        spec_decode=SpecDecodeConfig(mode="ngram", gamma=4, ngram=3))


def staged_serving_config() -> FrameworkConfig:
    """DDIM-50 served through the stage graph (serving/stages.py): CLIP
    encode, the denoise steps and the VAE decode batch independently, and
    the denoise stage admits and retires requests at step granularity.
    A solo request's image equals the monolithic path's for the same
    seed; CASSMANTLE_NO_STAGED_SERVING=1 is the kill switch."""
    return FrameworkConfig(serving=ServingConfig(staged_serving=True))


def test_config() -> FrameworkConfig:
    """The reference's tiny CPU-test geometry: small models, 64px images."""

    return FrameworkConfig(
        models=ModelZooConfig(
            clip_text=ClipTextConfig(
                vocab_size=1024, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, max_positions=16,
            ),
            unet=UNetConfig(
                base_channels=32, channel_mults=(1, 2), num_heads=4,
                attention_levels=(True, False), transformer_depth=(1, 0),
                blocks_per_level=1, context_dim=64, time_embed_dim=128,
                dtype="float32",
            ),
            vae=VAEConfig(base_channels=32, channel_mults=(1, 2),
                          blocks_per_level=1, dtype="float32"),
            gpt2=GPT2Config(vocab_size=256, hidden_size=64, num_layers=2,
                            num_heads=4, max_positions=64, dtype="float32"),
            minilm=MiniLMConfig(vocab_size=512, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4, max_positions=32),
            param_dtype="float32",
        ),
        sampler=SamplerConfig(num_steps=4, image_size=64, max_new_tokens=8,
                              min_new_tokens=2, prompt_pad_len=16,
                              negative_prompt=""),
        game=GameConfig(time_per_prompt=2.0, lock_timeout=5.0,
                        acquire_timeout=0.5),
    )


def test_sdxl_config() -> FrameworkConfig:
    """Tiny SDXL-shaped config for CPU tests: dual towers, micro-conds."""

    base = test_config()
    tower = base.models.clip_text
    tower2 = dataclasses.replace(tower, hidden_size=96, num_heads=4)
    return base.replace(
        models=dataclasses.replace(
            base.models,
            clip_text_2=tower2,
            unet=UNetConfig(
                base_channels=32, channel_mults=(1, 2), num_heads=4,
                attention_levels=(False, True), transformer_depth=(0, 2),
                blocks_per_level=1, context_dim=tower.hidden_size + 96,
                time_embed_dim=128,
                # pooled (96) + 6 sinusoidal time_ids x 32
                addition_embed_dim=96 + 6 * 32,
                dtype="float32",
            ),
            vae=dataclasses.replace(base.models.vae, scaling_factor=0.13025),
        ),
    )
