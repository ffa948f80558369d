"""Model configuration schema for the architecture zoo: the port's own
copy of ``repro.models.config`` (importing that would load JAX)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | rwkv | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # override (gemma-7b: 256)
    mlp_act: str = "silu"                # silu => SwiGLU, gelu => GeGLU
    qkv_bias: bool = False               # qwen2.5 style
    sliding_window: Optional[int] = None  # danube SWA
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / RWKV
    ssm_state: int = 0
    ssm_heads: int = 0
    conv_width: int = 4
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    attn_every: int = 0
    # modality stub: 'vision' | 'audio' -> input is precomputed embeddings
    frontend: Optional[str] = None
    # serving
    max_seq_len: int = 4096

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.dh

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.dh

    @property
    def attention_free(self) -> bool:
        return self.family in ("ssm", "rwkv")

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape: SSM/hybrid/sliding-window."""
        return self.family in ("ssm", "rwkv", "hybrid") or self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ accounting
    def param_count(self) -> int:
        """Closed-form parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        n = v * d                        # embedding
        if not self.tie_embeddings:
            n += v * d                   # head
        n += d                           # final norm
        per_layer = 0
        if self.family in ("dense", "vlm", "audio", "moe"):
            att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                att += self.q_dim + 2 * self.kv_dim
            per_layer += att + 2 * d     # attn + 2 norms
            if self.family == "moe":
                per_layer += d * self.n_experts                      # router
                per_layer += self.n_experts * 3 * d * self.moe_d_ff  # experts
                if self.n_shared_experts:
                    per_layer += 3 * d * (self.n_shared_experts * self.moe_d_ff)
            else:
                per_layer += 3 * d * self.d_ff
        elif self.family in ("ssm", "hybrid"):
            per_layer += self._ssm_block_params() + d      # block + 1 norm
        elif self.family == "rwkv":
            lora = 64
            per_layer += (5 * d * d                        # r,k,v,g,o projections
                          + 2 * lora * d + 2 * d           # decay LoRA + w0/ln_x
                          + 5 * d                          # mixing mus
                          + (self.ssm_heads or d // 64) * 64)   # bonus u
            per_layer += 2 * d * self.d_ff + d * d + 2 * d  # channel mix + mus
            per_layer += 2 * d                              # block norms
        total = n + self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + 2 * d
            total += att + 3 * d * self.d_ff   # ONE shared attention+MLP block
        return total

    def _ssm_block_params(self) -> int:
        d = self.d_model
        h = self.ssm_heads or max(1, d // 128)
        n_state = self.ssm_state
        d_inner = 2 * d
        return (d * (2 * d_inner + 2 * n_state + h)         # in_proj (x,z,B,C,dt)
                + self.conv_width * d_inner                 # conv1d
                + h + h                                     # A_log, D
                + d_inner * d)                              # out_proj

    def active_param_count(self) -> int:
        """For MoE: params touched per token (6*N_active*D flops model)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        return dense + self.n_layers * self.top_k * 3 * d * self.moe_d_ff


def param_count_shortfall(cfg: ModelConfig) -> int:
    """How far ``cfg.param_count()`` falls short of the parameters that
    ``init_params`` builds, a fault of the JAX package's formula that this
    copy keeps: for the ``ssm`` and ``hybrid`` families it counts h =
    ssm_heads or d_model // 128 Mamba2 heads and two H-vectors, where the
    block has H = d_inner // 64 heads (or ssm_heads) and three (``dt_bias``,
    ``A_log``, ``D``): short by n_layers ((H - h) d_model + 3H - 2h)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    d = cfg.d_model
    H = cfg.ssm_heads or 2 * d // 64
    h = cfg.ssm_heads or max(1, d // 128)
    return cfg.n_layers * ((H - h) * d + 3 * H - 2 * h)
