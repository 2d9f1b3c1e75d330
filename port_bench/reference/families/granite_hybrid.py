"""The `granite_hybrid` family: Granite-4.0-H's decoder block over feature
frames (https://huggingface.co/ibm-granite/granite-4.0-h-micro, config.json;
Mamba-2 from Dao and Gu, arXiv:2405.21060).

    h = 12 Dense(e)                          (the token embedding's place)
    per layer: h = h + 0.22 mixer(RMSNorm(h)); h = h + 0.22 MLP(RMSNorm(h))
    MLP(x) = W_out(silu(x W_g) * x W_u)      (one input kernel, gate first)
    the last frame of RMSNorm(h), a Dense

A Mamba-2 mixer: [z | xBC | dt] = x W_in; xBC = silu(causal depthwise
conv_4(xBC) + b) split into x, B and C; dt = softplus(dt + dt_bias),
A = -exp(A_log) per head; per head y_t = s_t C_t + D x_t with
s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T; out = W_o RMSNorm(y * silu(z)).
Here the scan is the masked-matrix form over the whole window, per head
y = (L o C B^T)(dt x) with L_ij = exp(sum_{k=j+1..i} dt_k A) for i >= j:
not the chunked algorithm the program runs, so the state the program
passes from chunk to chunk is checked, not copied.

An attention layer: softmax(0.015625 Q K^T + causal mask) V with 32 query
heads and 8 key/value heads, each shared by 4 query heads (repeated here),
no biases, no positions; then W_o.

The multipliers, the norms' eps and the one group of B and C are the
published values, fixed here (`PUBLISHED`); every width is read from the
variables' shapes. `ssd_work` gives a scan's operations and bytes for the
`ssm.scan_roofline_pct.bulk` metric.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from port_bench.reference.models import operands

# one H100 SXM at 700 W, as port_bench/flops.py has them (the reference
# imports nothing outside reference/)
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12

PUBLISHED = {"granite_embedding_multiplier": 12.0,
             "granite_residual_multiplier": 0.22,
             "granite_attention_multiplier": 0.015625,
             "granite_rms_norm_eps": 1e-5,
             "granite_mamba_n_groups": 1}
TEMPORARY_BYTES = 8e9    # the float64 temporaries of one block of clips


def _matmul(a, b, prec):
    a, b = operands(prec, a, b)
    return a @ b


def _dense(x, p, prec):
    y = _matmul(x, p["kernel"], prec)
    return y + p["bias"] if "bias" in p else y


def _rmsnorm(x, p):
    eps = PUBLISHED["granite_rms_norm_eps"]
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]


def _silu(x):
    return x * torch.sigmoid(x)


def _ssd(x, dt, a, b, c, prec):
    """x [N, T, H, P], dt [N, T, H], a [H], b and c [N, T, G, N_s] -> y
    [N, T, H, P] by the masked-matrix form over the whole window."""
    t, h = x.shape[1], x.shape[2]
    heads_per_group = h // b.shape[2]
    cum = torch.cumsum(dt * a, dim=1).transpose(1, 2)           # [N, H, T]
    later = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(later, float("-inf")))       # [N, H, T, T]
    cb = _matmul(c.transpose(1, 2), b.permute(0, 2, 3, 1), prec)  # [N, G, T, T]
    mix = decay * cb.repeat_interleave(heads_per_group, dim=1)
    xdt = (x * dt[..., None]).transpose(1, 2)                   # [N, H, T, P]
    return _matmul(mix, xdt, prec).transpose(1, 2)


def _mamba(x, p, prec):
    inner = p["RMSNorm_0"]["scale"].shape[0]
    heads = p["A_log"].shape[0]
    conv = p["Conv_0"]["kernel"]                                # [k, 1, C]
    groups = PUBLISHED["granite_mamba_n_groups"]
    state = (conv.shape[2] - inner) // (2 * groups)
    n, t, _ = x.shape
    z, xbc, dt = torch.split(_dense(x, p["Dense_0"], prec),
                             [inner, conv.shape[2], heads], dim=-1)
    k, w = operands(prec, F.pad(xbc.transpose(1, 2), (conv.shape[0] - 1, 0)),
                    conv.permute(2, 1, 0))
    xbc = _silu(F.conv1d(k, w, p["Conv_0"]["bias"],
                         groups=conv.shape[2]).transpose(1, 2))
    xs, b, c = torch.split(xbc, [inner, groups * state, groups * state],
                           dim=-1)
    xs = xs.reshape(n, t, heads, inner // heads)
    dt = F.softplus(dt + p["dt_bias"])
    y = _ssd(xs, dt, -torch.exp(p["A_log"]),
             b.reshape(n, t, groups, state), c.reshape(n, t, groups, state),
             prec) + p["D"][:, None] * xs
    y = y.reshape(n, t, inner) * _silu(z)
    return _dense(_rmsnorm(y, p["RMSNorm_0"]), p["Dense_1"], prec)


def _attention(x, p, prec):
    n, t, d = x.shape
    heads, head_dim = p["query"]["kernel"].shape[1:]
    kv_heads = p["key"]["kernel"].shape[1]

    def project(name, count):
        y = _matmul(x, p[name]["kernel"].reshape(d, count * head_dim), prec)
        return y.view(n, t, count, head_dim).transpose(1, 2)

    q = project("query", heads) * PUBLISHED["granite_attention_multiplier"]
    k = project("key", kv_heads).repeat_interleave(heads // kv_heads, dim=1)
    v = project("value", kv_heads).repeat_interleave(heads // kv_heads, dim=1)
    later = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    weights = torch.softmax(_matmul(q, k.transpose(-1, -2), prec)
                            .masked_fill(later, float("-inf")), dim=-1)
    mixed = _matmul(weights, v, prec).transpose(1, 2).reshape(n, t, -1)
    return _matmul(mixed, p["out"]["kernel"].reshape(-1, d), prec)


def _mlp(x, p, prec):
    gate, up = torch.chunk(_dense(x, p["Dense_0"], prec), 2, dim=-1)
    return _dense(_silu(gate) * up, p["Dense_1"], prec)


def _layers(p) -> list:
    return [p[f"GraniteHybridLayer_{i}"] for i in range(sum(
        k.startswith("GraniteHybridLayer_") for k in p))]


def _block_size(x, p) -> int:
    """Clips a block so that the largest float64 temporaries, two at a time
    (a scan's [H, T, T] decay, attention's [heads, T, T] scores, the MLP's
    [T, 2 inner]), stay under TEMPORARY_BYTES."""
    t, rows = x.shape[1], []
    for lay in _layers(p):
        rows.append(lay["GatedMLP_0"]["Dense_0"]["kernel"].shape[1])
        mixer = lay.get("Mamba2Mixer_0")
        rows.append(t * (mixer["A_log"].shape[0] if mixer is not None else
                         lay["MultiHeadDotProductAttention_0"]["query"]
                         ["kernel"].shape[1]))
    return max(1, int(TEMPORARY_BYTES // (2 * 8 * t * max(rows))))


def backbone(x, variables, prec):
    p = variables["params"]["backbone"]
    r = PUBLISHED["granite_residual_multiplier"]
    block = _block_size(x, p)
    out = []
    for i in range(0, x.shape[0], block):
        h = _dense(x[i:i + block], p["Dense_0"], prec) \
            * PUBLISHED["granite_embedding_multiplier"]
        for lay in _layers(p):
            x_in = _rmsnorm(h, lay["RMSNorm_0"])
            if "Mamba2Mixer_0" in lay:
                h = h + r * _mamba(x_in, lay["Mamba2Mixer_0"], prec)
            else:
                h = h + r * _attention(
                    x_in, lay["MultiHeadDotProductAttention_0"], prec)
            h = h + r * _mlp(_rmsnorm(h, lay["RMSNorm_1"]), lay["GatedMLP_0"],
                             prec)
        out.append(_dense(_rmsnorm(h[:, -1], p["RMSNorm_0"]), p["Dense_1"],
                          prec))
    return torch.cat(out)


# -- shapes, operations and bytes ------------------------------------------------


def _sizes(model: dict) -> dict:
    """The widths of a configuration file's granite_hybrid entry; the keys
    this reference fixes must hold their published values."""
    for key, value in PUBLISHED.items():
        if float(model.get(key, value)) != value:
            raise ValueError(f"{key} {model[key]} is not the published "
                             f"{value} that the reference computes with")
    d = int(model["granite_d_model"])
    heads = int(model["granite_mamba_n_heads"])
    head_dim = int(model["granite_mamba_d_head"])
    state = int(model["granite_mamba_d_state"])
    return {"d": d, "types": list(model["granite_layer_types"])[
                :int(model["n_blocks"])],
            "inner_mlp": int(model["granite_intermediate_size"]),
            "heads": heads, "head_dim": head_dim, "state": state,
            "inner": heads * head_dim, "conv_dim": heads * head_dim
            + 2 * state * PUBLISHED["granite_mamba_n_groups"],
            "taps": int(model["granite_mamba_d_conv"]),
            "chunk": int(model["granite_mamba_chunk_size"]),
            "q_heads": int(model["granite_attention_heads"]),
            "kv_heads": int(model["granite_kv_heads"])}


@dataclass(frozen=True)
class SsdWork:
    operations: int    # two per multiply-add of the chunked algorithm's products
    bytes: int         # x, B, C, dt read and y written once, float32

    def least_seconds(self) -> float:
        """The larger of the bytes at 3.35 TB/s and the operations at the
        float32 peak, 67 TFLOP/s, of one H100."""
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.operations / FP32_PEAK)


def ssd_work(batch: int, length: int, heads: int, head_dim: int, state: int,
             groups: int, chunk: int) -> SsdWork:
    """One scan of [batch, length] frames by the chunked algorithm at
    `chunk`: per chunk of q positions C B^T (groups x q^2 x state), the
    masked product with dt x (heads x q^2 x head_dim), the chunk's state
    B^T (dt x) and the entering state read through C (heads x q x state x
    head_dim each). The states passed between chunks are elementwise and
    not counted."""
    macs = 0
    for start in range(0, length, chunk):
        q = min(chunk, length - start)
        macs += (groups * q * q * state + heads * q * q * head_dim
                 + 2 * heads * q * state * head_dim)
    frames = batch * length
    per_frame = 2 * heads * head_dim + 2 * groups * state + heads
    return SsdWork(2 * batch * macs, 4 * frames * per_frame)


def flops(model: dict) -> int:
    """Model FLOPs of the backbone on one window of T frames: the Dense to
    d, per Mamba-2 layer the input projection, the depthwise convolution,
    the scan (`ssd_work`) and the output projection, per attention layer the
    four projections and Q K^T and A V over the full window, per layer the
    gated MLP; the Dense on the last frame."""
    s = _sizes(model)
    t, features = model["input_shape"]
    d, mlp = s["d"], s["inner_mlp"]
    hd = d // s["q_heads"]
    macs = t * features * d + d * model["embedding_dim"]
    ops = 0
    for kind in s["types"]:
        macs += t * 3 * d * mlp
        if kind == "mamba":
            macs += t * d * (s["inner"] + s["conv_dim"] + s["heads"]) \
                + t * s["conv_dim"] * s["taps"] + t * s["inner"] * d
            ops += ssd_work(1, t, s["heads"], s["head_dim"], s["state"],
                            PUBLISHED["granite_mamba_n_groups"],
                            s["chunk"]).operations
        else:
            macs += t * d * (2 * d + 2 * s["kv_heads"] * hd) \
                + 2 * t * t * s["q_heads"] * hd
    return 2 * macs + ops


def layout(model: dict) -> dict:
    """{"params": ...}: the shape of every leaf of a configuration file's
    granite_hybrid entry, as the port's flax layout names them."""
    s = _sizes(model)
    _, features = model["input_shape"]
    d, emb = s["d"], model["embedding_dim"]
    hd = d // s["q_heads"]
    mlp = {"Dense_0": {"kernel": (d, 2 * s["inner_mlp"])},
           "Dense_1": {"kernel": (s["inner_mlp"], d)}}
    mamba = {"Dense_0": {"kernel": (d, s["inner"] + s["conv_dim"]
                                    + s["heads"])},
             "Conv_0": {"kernel": (s["taps"], 1, s["conv_dim"]),
                        "bias": (s["conv_dim"],)},
             "A_log": (s["heads"],), "D": (s["heads"],),
             "dt_bias": (s["heads"],),
             "RMSNorm_0": {"scale": (s["inner"],)},
             "Dense_1": {"kernel": (s["inner"], d)}}
    attention = {"query": {"kernel": (d, s["q_heads"], hd)},
                 "key": {"kernel": (d, s["kv_heads"], hd)},
                 "value": {"kernel": (d, s["kv_heads"], hd)},
                 "out": {"kernel": (s["q_heads"], hd, d)}}
    backbone = {"Dense_0": {"kernel": (features, d), "bias": (d,)},
                "RMSNorm_0": {"scale": (d,)},
                "Dense_1": {"kernel": (d, emb), "bias": (emb,)}}
    for i, kind in enumerate(s["types"]):
        mixer = {"Mamba2Mixer_0": mamba} if kind == "mamba" \
            else {"MultiHeadDotProductAttention_0": attention}
        backbone[f"GraniteHybridLayer_{i}"] = {
            "RMSNorm_0": {"scale": (d,)}, **mixer,
            "RMSNorm_1": {"scale": (d,)}, "GatedMLP_0": mlp}
    return {"params": {"backbone": backbone,
                       "Dense_0": {"kernel": (emb, emb // 2),
                                   "bias": (emb // 2,)},
                       "Dense_1": {"kernel": (emb // 2, 1), "bias": (1,)}}}
