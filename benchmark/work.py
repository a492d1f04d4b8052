"""Frozen counting code: the operations and bytes of a kernel call and of a
model step, from shapes, and the published peaks of the chip.

Nothing here reads the program: the sizes come from the benchmark's own
configuration files (``configs/<name>.json``), so a change to the program
cannot change what a call or a step is worth.

Conventions:

* a matmul of [M, K] x [K, N] is 2 M K N operations;
* attention counts the (query, key) pairs its inputs need (causal: the
  keys at or before the query), 4 d operations a pair and head forward
  (Q K^T and P V) and 2.5 times that backward (S recomputed, dP, dV, dQ,
  dK: five products where the forward has two);
* a roofline counts each input byte read once and each output byte
  written once, whatever a kernel reads again or keeps in a workspace;
* model FLOPs count what the model needs: padding, a repeated token and a
  layer recomputed under remat are not counted.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

BF16, FP32, INT8 = 2, 4, 1


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """The least time (s) the work takes on the chip, and what bounds it:
    "operations" or "bytes"."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# --------------------------------------------------------------------------
# sizes
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Sizes:
    """The shapes a configuration file states (``configs/<name>.json``)."""

    layers: int
    hidden: int
    ffn: int
    heads: int
    kv_heads: int
    vocab: int
    v_hidden: int
    v_ffn: int
    v_layers: int
    image: int
    patch: int
    proj: int
    a_mels: int
    a_dim: int
    a_ffn: int
    a_layers: int
    a_heads: int
    a_frames: int   # mel frames of one clip (30 s at hop 160: 3000)
    frames: int     # video frames a request carries
    align_heads: int
    conv: dict      # modality -> (kernel, stride)

    @classmethod
    def of(cls, cfg: dict) -> "Sizes":
        v, a, f = cfg["vision"], cfg["audio"], cfg["fusion"]
        return cls(
            layers=cfg["num_hidden_layers"], hidden=cfg["hidden_size"],
            ffn=cfg["intermediate_size"], heads=cfg["num_attention_heads"],
            kv_heads=cfg["num_key_value_heads"], vocab=cfg["vocab_size"],
            v_hidden=v["hidden_size"], v_ffn=v["intermediate_size"],
            v_layers=v["num_hidden_layers"],
            image=v["image_size"], patch=v["patch_size"],
            proj=v["projection_dim"], a_mels=a["num_mel_bins"],
            a_dim=a["d_model"], a_ffn=a["encoder_ffn_dim"],
            a_layers=a["encoder_layers"],
            a_heads=a["encoder_attention_heads"],
            a_frames=a["sample_rate"] * a["chunk_length_s"]
            // a["hop_length"],
            frames=f["n_frames"], align_heads=2 * f["attention_heads"],
            conv={"image": (f["image_conv_kernel"], f["image_conv_stride"]),
                  "video": (f["video_conv_kernel"], f["video_conv_stride"]),
                  "audio": (f["audio_conv_kernel"], f["audio_conv_stride"])})

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def patches(self) -> int:
        return (self.image // self.patch) ** 2

    def conv_len(self, mod: str) -> int:
        """Positions a modality's VALID conv leaves."""
        n = {"image": self.patches, "video": self.frames * self.patches,
             "audio": self.a_frames // 2}[mod]
        k, s = self.conv[mod]
        return (n - k) // s + 1

    @property
    def prefix_len(self) -> int:
        """Fused positions the media take: three blocks and their six
        boundary tokens."""
        return sum(self.conv_len(m) for m in ("image", "video", "audio")) + 6

    @property
    def layer_params(self) -> int:
        """Weights of one decoder layer's matmuls."""
        h = self.hidden
        return 2 * h * h + 2 * h * self.kv_dim + 3 * h * self.ffn


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def attn_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the attention needs; causal with sq == sk keys
    at or before the query, with sq < sk the queries are the last ones."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(i + 1 + off, sk) for i in range(sq))


def attn_flops(b: int, sq: int, sk: int, n: int, d: int,
               causal: bool) -> float:
    """Forward FLOPs (Q K^T and P V)."""
    return 4.0 * b * n * d * attn_pairs(sq, sk, causal)


def attn_bwd_flops(b: int, sq: int, sk: int, n: int, d: int,
                   causal: bool) -> float:
    """Backward FLOPs given the forward's log-sum-exp: S again, dP, dV,
    dQ, dK."""
    return 2.5 * attn_flops(b, sq, sk, n, d, causal)


def flash_fwd_bytes(b: int, sq: int, sk: int, n: int, d: int,
                    bias: bool = False) -> float:
    """q, k, v read and o written in bf16, the fp32 log-sum-exp written,
    and the fp32 padding bias [B, Sk] read when there is one."""
    q = b * sq * n * d
    kv = b * sk * n * d
    return BF16 * (2 * q + 2 * kv) + FP32 * b * n * sq + \
        (FP32 * b * sk if bias else 0)


def flash_bwd_bytes(b: int, sq: int, sk: int, n: int, d: int,
                    bias: bool = False) -> float:
    """q, k, v, o and dO read and dQ, dK, dV written in bf16, the fp32
    log-sum-exp read (and the bias). The delta vector is the backward's
    own intermediate."""
    q = b * sq * n * d
    kv = b * sk * n * d
    return BF16 * (3 * q + 2 * kv + q + 2 * kv) + FP32 * b * n * sq + \
        (FP32 * b * sk if bias else 0)


def flash_fwd_bound_s(b, sq, sk, n, d, causal, bias=False) -> float:
    return bound_s(attn_flops(b, sq, sk, n, d, causal),
                   flash_fwd_bytes(b, sq, sk, n, d, bias))[0]


def flash_bwd_bound_s(b, sq, sk, n, d, causal, bias=False) -> float:
    return bound_s(attn_bwd_flops(b, sq, sk, n, d, causal),
                   flash_bwd_bytes(b, sq, sk, n, d, bias))[0]


# --------------------------------------------------------------------------
# the int8 matvec (weight-only int8 x bf16 rows)
# --------------------------------------------------------------------------

def matvec_flops(rows: int, k: int, n: int) -> float:
    return 2.0 * rows * k * n


def matvec_bytes(rows: int, k: int, n: int) -> float:
    """The int8 weight and its fp32 per-column scale read, the bf16 rows
    read and the bf16 output written."""
    return INT8 * k * n + FP32 * n + BF16 * rows * (k + n)


def matvec_bound_s(rows: int, k: int, n: int) -> float:
    return bound_s(matvec_flops(rows, k, n), matvec_bytes(rows, k, n))[0]


def decode_matvecs(s: Sizes) -> list:
    """(K, N, calls a step) of a decode step's int8 projections in the
    packed serving layout: qkv, wo, gate|up, down a layer, and the head."""
    h, L = s.hidden, s.layers
    return [(h, h + 2 * s.kv_dim, L), (h, h, L), (h, 2 * s.ffn, L),
            (s.ffn, h, L), (h, s.vocab, 1)]


def decode_step_matvec_bound_s(s: Sizes, rows: float) -> float:
    """The least time of one decode step's matvecs at ``rows`` rows."""
    return sum(calls * matvec_bound_s(rows, k, n)
               for k, n, calls in decode_matvecs(s))


def head_matvec_bound_s(s: Sizes) -> float:
    """An admission's one-row head projection (its first token)."""
    return matvec_bound_s(1, s.hidden, s.vocab)


# --------------------------------------------------------------------------
# the towers and the fusion, per request (one image, one clip, one audio)
# --------------------------------------------------------------------------

def clip_flops(s: Sizes, images: int) -> float:
    """CLIP ViT forward over ``images`` images: the patch embedding, the
    layers over CLS + patches, the projection of the patch tokens."""
    p, hv = s.patches, s.v_hidden
    t = p + 1
    patch = 2.0 * p * (3 * s.patch * s.patch) * hv
    layer = 2.0 * t * (4 * hv * hv + 2 * hv * s.v_ffn) + 4.0 * hv * t * t
    proj = 2.0 * p * hv * s.proj
    return images * (patch + s.v_layers * layer + proj)


def whisper_flops(s: Sizes, clips: int) -> float:
    """Whisper encoder forward: two convs, the layers over the frames."""
    d, t = s.a_dim, s.a_frames // 2
    convs = 2.0 * s.a_frames * 3 * s.a_mels * d + 2.0 * t * 3 * d * d
    layer = 2.0 * t * (4 * d * d + 2 * d * s.a_ffn) + 4.0 * d * t * t
    return clips * (convs + s.a_layers * layer)


def video_attn_flops(s: Sizes, clips: int) -> float:
    """The self-attention over every frame's patch tokens (bias_k and the
    zero row add two keys)."""
    t, e = s.frames * s.patches, s.proj
    return clips * (2.0 * t * 3 * e * e + 4.0 * e * t * (t + 2)
                    + 2.0 * t * e * e)


def fusion_head_flops(s: Sizes, requests: int) -> float:
    """Conv downsampling, the projection to the LLM width and the
    alignment attention over the whole token embedding (its K/V rows are
    computed once, not per request) of every modality."""
    h, total = s.hidden, 0.0
    for mod, width in (("image", s.proj), ("video", s.proj),
                       ("audio", s.a_dim)):
        k, _ = s.conv[mod]
        p = s.conv_len(mod)
        total += 2.0 * p * k * width * width + 2.0 * p * width * h
        total += 2.0 * p * h * h + 4.0 * p * h * (s.vocab + 2) \
            + 2.0 * p * h * h
    return requests * total


def media_flops(s: Sizes, requests: int) -> float:
    """Everything the media of ``requests`` requests cost before the LLM:
    CLIP over the image and each frame, Whisper, the video attention, and
    the fusion head."""
    return (clip_flops(s, requests * (1 + s.frames))
            + whisper_flops(s, requests) + video_attn_flops(s, requests)
            + fusion_head_flops(s, requests))


# --------------------------------------------------------------------------
# the LLM
# --------------------------------------------------------------------------

def llm_prefill_flops(s: Sizes, tokens: int) -> float:
    """A prompt of ``tokens`` positions through the stack, causal, and the
    head at its last position."""
    return (s.layers * (2.0 * s.layer_params * tokens
                        + 4.0 * s.hidden * attn_pairs(tokens, tokens, True))
            + 2.0 * s.hidden * s.vocab)


def llm_decode_flops(s: Sizes, ctx: int) -> float:
    """One decoded token whose attention sees ``ctx`` keys (itself
    included), and the head."""
    return (s.layers * (2.0 * s.layer_params + 4.0 * s.hidden * ctx)
            + 2.0 * s.hidden * s.vocab)


def qlora_step_flops(s: Sizes, rows: int, text: int, rank: int,
                     media: bool = True) -> float:
    """One QLoRA step over ``rows`` rows of ``text`` tokens, with media or
    without: the frozen towers forward; the fusion forward, its input and
    weight gradients (twice the forward); the LLM forward and its input
    gradients through the frozen base (2 + 2 per weight and token), the
    attention forward and backward, the head forward and input gradient,
    and the LoRA adapters' forward and both gradients. Remat recompute is
    not counted."""
    t = text + (s.prefix_len if media else 0)
    tokens = rows * t
    towers = fusion = 0.0
    if media:
        towers = clip_flops(s, rows * (1 + s.frames)) + whisper_flops(s, rows)
        fusion = video_attn_flops(s, rows) + fusion_head_flops(s, rows)
    n, d = s.heads, s.head_dim
    attn = s.layers * (attn_flops(rows, t, t, n, d, True)
                       + attn_bwd_flops(rows, t, t, n, d, True))
    base = 4.0 * s.layers * s.layer_params * tokens
    head = 4.0 * s.hidden * s.vocab * tokens
    lora = 3.0 * s.layers * 2.0 * tokens * rank * (2 * s.hidden + s.hidden
                                                    + s.kv_dim)
    return towers + 3.0 * fusion + base + attn + head + lora
