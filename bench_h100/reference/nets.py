"""The reference models as functions of a state dict.

:class:`Net` computes the benchmarked models from a dict of float32 tensors
keyed by the reference repo's state-dict names, with the structure read off
the configuration (``MODEL.EXTRA``'s stages, the encoder sizes):

* the HRNet-W48-S trunk (stem, ``layer1`` of four bottlenecks, stages 2 and
  3 with their transitions and full multi-scale fusion), BatchNorm folded
  from running statistics in eval, over the valid persons in training;
* the ``conv`` box-mask position embedding and the 2-D sine table;
* the post-norm DETR encoder (position added to q and k, ReLU FFN), with
  the training dropout the port draws: on the attention weights, the
  attention output and both FFN sites, keyed by the step's seed;
* ``interformer_pureMulti`` (one inter encoder over the 16x12 tokens of all
  persons of an image, one deconv block applied twice, a 1x1 head) and the
  TransPose-H two-stage ``interformer`` (a 6-layer intra encoder over the
  3072 tokens of each person, pooled to the inter encoder's grid, the deconv
  block twice, the residual on the first stage's features).

``quant`` rounds every operand of a product (convolutions, linear layers,
the attention's two products); the identity computes in float32. The
benchmark's control passes an fp8 rounding (:func:`fp8`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference.geometry import sine_table

#: the first dropout offset of the TransPose-H intra encoder; four a layer
INTRA_OFFSET_BASE = 128
OFFSETS_PER_LAYER = 4
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """Float32 products without TF32 inside the block, and cuDNN's algorithms
    by its heuristics (no timed search, whose choice and seconds vary from
    run to run); the settings restored after."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = b.cudnn.benchmark = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale a tensor, back in float32;
    its gradient passes straight through."""
    s = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
    y = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (y - x).detach()


# --- the dropout bits: Philox4x32-10 and torch's Bernoulli stream ------------------------------

_MASK = 0xFFFFFFFF


def _mulhilo(x, m: int):
    t_hi = (x >> 16) * m
    t_lo = (x & 0xFFFF) * m
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox_word0(seed: int, offset: int, c0, c1, c2) -> torch.Tensor:
    """Word 0 of Philox4x32-10 keyed (seed, offset) at counter (c0, c1, c2, 0), int64."""
    k0, k1 = int(seed) & _MASK, int(offset) & _MASK
    dev = next(c.device for c in (c0, c1, c2) if isinstance(c, torch.Tensor))
    x0, x1, x2, x3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) for c in (c0, c1, c2, 0)))
    for _ in range(10):
        hi0, lo0 = _mulhilo(x0, 0xD2511F53)
        hi1, lo1 = _mulhilo(x2, 0xCD9E8D57)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK, (k1 + 0xBB67AE85) & _MASK
    return x0


def keep_of(bits: torch.Tensor, rate: float) -> torch.Tensor:
    return bits >= min(int(round(rate * 4294967296.0)), 4294967295)


def bernoulli_dropout(x: torch.Tensor, rate: float, seed: int, offset: int) -> torch.Tensor:
    """Dropout of the attention output: a Bernoulli draw from a generator on
    x's device seeded with ``seed * 2^8 + offset``."""
    g = torch.Generator(device=x.device).manual_seed((int(seed) << 8) + int(offset))
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=g)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


class Net:
    """The reference forward of ``cfg``'s model over ``params``.

    ``train`` switches BatchNorm to the statistics of the valid persons
    (``valid``, the [rows] mask) and turns on dropout at ``rate`` keyed by
    ``seed``; ``calibrate`` sets every BatchNorm's running statistics to the
    batch statistics it sees, then normalises with them."""

    def __init__(self, params, cfg, quant=None):
        self.p = params
        self.m = cfg["MODEL"]
        self.q = quant or (lambda t: t)
        self.train = False
        self.calibrate = False
        self.valid = None
        self.seed = None
        self.rate = 0.0

    # --- layers -----------------------------------------------------------------------------
    def conv(self, x, name, stride=1):
        w = self.p[name + ".weight"]
        return F.conv2d(self.q(x), self.q(w), self.p.get(name + ".bias"), stride, w.shape[-1] // 2)

    def linear(self, x, w, b):
        return F.linear(self.q(x), self.q(w), b)

    def bn(self, x, name, eps=1e-5):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.calibrate:
            mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
            self.p[name + ".running_mean"].copy_(mean.detach())
            self.p[name + ".running_var"].copy_(var.detach())
        elif self.train:
            m = self.valid.float()[:, None, None, None]
            cnt = torch.clamp(m.sum() * x.shape[2] * x.shape[3], min=1.0)
            mean = (x * m).sum((0, 2, 3)) / cnt
            var = (((x - mean[:, None, None]) ** 2) * m).sum((0, 2, 3)) / cnt
        else:
            mean, var = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        scale = torch.rsqrt(var + eps) * w
        return (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None]

    def conv_bn(self, x, name, stride=1, relu=True):
        y = self.bn(self.conv(x, name + ".0", stride), name + ".1")
        return F.relu(y) if relu else y

    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"], 1e-5)

    def deconv(self, x, name):
        """ConvTranspose2d(4, stride 2, padding 1) + BN + ReLU: exactly 2x."""
        y = F.conv_transpose2d(self.q(x), self.q(self.p[name + ".0.weight"]), None, 2, 1, 0)
        return F.relu(self.bn(y, name + ".1"))

    # --- HRNet-W48-S ----------------------------------------------------------------------------
    def block(self, x, name, kind, planes):
        cin = x.shape[1]
        exp = 4 if kind == "BOTTLENECK" else 1
        if kind == "BOTTLENECK":
            out = F.relu(self.bn(self.conv(x, name + ".conv1"), name + ".bn1"))
            out = F.relu(self.bn(self.conv(out, name + ".conv2"), name + ".bn2"))
            out = self.bn(self.conv(out, name + ".conv3"), name + ".bn3")
        else:
            out = F.relu(self.bn(self.conv(x, name + ".conv1"), name + ".bn1"))
            out = self.bn(self.conv(out, name + ".conv2"), name + ".bn2")
        res = x if cin == planes * exp else self.conv_bn(x, name + ".downsample", relu=False)
        return F.relu(out + res)

    def hr_module(self, xs, name, sc):
        outs = []
        for i, x in enumerate(xs):
            for j in range(sc["NUM_BLOCKS"][i]):
                x = self.block(x, f"{name}.branches.{i}.{j}", sc["BLOCK"], sc["NUM_CHANNELS"][i])
            outs.append(x)
        if len(outs) == 1:
            return outs
        fused = []
        for i in range(len(outs)):
            y = 0
            for j, t in enumerate(outs):
                if j > i:
                    t = self.conv_bn(t, f"{name}.fuse_layers.{i}.{j}", relu=False)
                    t = F.interpolate(t, scale_factor=2 ** (j - i), mode="nearest")
                elif j < i:
                    for k in range(i - j):
                        t = self.conv_bn(t, f"{name}.fuse_layers.{i}.{j}.{k}", 2,
                                         relu=k < i - j - 1)
                y = y + t
            fused.append(F.relu(y))
        return fused

    def trunk(self, x, pre=""):
        x = F.relu(self.bn(self.conv(x, pre + "conv1", 2), pre + "bn1"))
        x = F.relu(self.bn(self.conv(x, pre + "conv2", 2), pre + "bn2"))
        for i in range(4):
            x = self.block(x, f"{pre}layer1.{i}", "BOTTLENECK", 64)
        xs = [x]
        for stage, trans in (("STAGE2", "transition1"), ("STAGE3", "transition2")):
            sc = self.m["EXTRA"][stage]
            exp = 4 if sc["BLOCK"] == "BOTTLENECK" else 1
            new = []
            for i, c in enumerate(sc["NUM_CHANNELS"]):
                c *= exp
                if i < len(xs):
                    new.append(xs[i] if xs[i].shape[1] == c
                               else self.conv_bn(xs[i], f"{pre}{trans}.{i}"))
                else:
                    y = xs[-1]
                    for j in range(i + 1 - len(xs)):
                        y = self.conv_bn(y, f"{pre}{trans}.{i}.{j}", 2)
                    new.append(y)
            xs = new
            for mi in range(sc["NUM_MODULES"]):
                xs = self.hr_module(xs, f"{pre}{stage.lower()}.{mi}", sc)
        return xs

    # --- position embedding and encoder ---------------------------------------------------------
    def box_embedding(self, pos_masks, name, tw):
        """The ``conv`` box-mask embedding [B, N, H, W, 1] -> tokens [B, N*th*tw, C]."""
        b, n, h, w, _ = pos_masks.shape
        x = pos_masks.reshape(b * n, 1, h, w)
        x = F.relu(self.bn(self.conv(x, name + ".conv1", 2), name + ".bn1"))
        x = F.relu(self.bn(self.conv(x, name + ".conv2", 2), name + ".bn2"))
        for _ in range(int(math.log2(x.shape[3] // tw))):
            x = F.max_pool2d(x, 3, 2, 1)
        return x.permute(0, 2, 3, 1).reshape(b, -1, x.shape[1])

    def attention(self, qk, v_in, name, heads, key_pad, offset):
        c = qk.shape[-1]
        w, bias = self.p[name + ".in_proj_weight"], self.p[name + ".in_proj_bias"]
        q = self.linear(qk, w[:c], bias[:c])
        k = self.linear(qk, w[c:2 * c], bias[c:2 * c])
        v = self.linear(v_in, w[2 * c:], bias[2 * c:])
        b, s, _ = q.shape
        d = c // heads

        def split(t):
            return t.reshape(b, s, heads, d).transpose(1, 2)

        logits = self.q(split(q)) @ self.q(split(k)).transpose(-1, -2) / math.sqrt(d)
        if key_pad is not None:
            logits = logits.masked_fill(key_pad[:, None, None, :], -1e30)
        p = torch.softmax(logits, dim=-1)
        if self.train and self.rate > 0:
            idx = torch.arange(s, device=q.device)
            bits = philox_word0(self.seed, offset, idx[None, None, :], idx[None, :, None],
                                torch.arange(b * heads, device=q.device)[:, None, None])
            p = torch.where(keep_of(bits, self.rate).view(b, heads, s, s),
                            p / (1.0 - self.rate), 0.0)
        out = (self.q(p) @ self.q(split(v))).transpose(1, 2).reshape(b, s, c)
        return self.linear(out, self.p[name + ".out_proj.weight"], self.p[name + ".out_proj.bias"])

    def ffn_dropout(self, x, offset):
        if not (self.train and self.rate > 0):
            return x
        rows, width = x.shape[0] * x.shape[1], x.shape[2]
        bits = philox_word0(self.seed, offset, torch.arange(width, device=x.device)[None, :],
                            torch.arange(rows, device=x.device)[:, None], 0)
        return torch.where(keep_of(bits, self.rate).view(x.shape), x / (1.0 - self.rate), 0.0)

    def encoder(self, x, name, layers, heads, key_pad, pos, offset_base=0):
        for i in range(layers):
            pre, off = f"{name}.layers.{i}", offset_base + OFFSETS_PER_LAYER * i
            qk = x if pos is None else x + pos
            att = self.attention(qk, x, pre + ".self_attn", heads, key_pad, off)
            if self.train and self.rate > 0:
                att = bernoulli_dropout(att, self.rate, self.seed, off + 1)
            n = self.layer_norm(x + att, pre + ".norm1")
            h = F.relu(self.linear(n, self.p[pre + ".linear1.weight"], self.p[pre + ".linear1.bias"]))
            y = self.linear(self.ffn_dropout(h, off + 2), self.p[pre + ".linear2.weight"],
                            self.p[pre + ".linear2.bias"])
            x = self.layer_norm(n + self.ffn_dropout(y, off + 3), pre + ".norm2")
        return x

    # --- the models -----------------------------------------------------------------------------
    def __call__(self, images, pos_masks, valid):
        """images [B, N, H, W, 3] normalised, pos_masks [B, N, H, W, 1], valid
        [B, N] -> heatmaps [B, N, K, H/4, W/4], padded persons zero."""
        if self.train:
            self.valid = valid.reshape(-1)
        m = self.m
        b, n, h, w, _ = images.shape
        x = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
        th, tw = m["TRANS_SIZE"]
        if m["NAME"] == "interformer_pureMulti":
            feat = self.conv(self.trunk(x)[-1], "reduce")
            res, name, layers, pe_name = None, "global_encoder", m["ENCODER_LAYERS"], "position_embedding"
        else:
            feat = self.transpose_h(x)
            res = feat
            for _ in range(int(math.log2(feat.shape[3] // tw))):
                feat = F.max_pool2d(feat, 3, 2, 1)
            name, layers = "multi_global_encoder", m["ENCODER_MULTI_LAYERS"]
            pe_name = "multi_position_embedding"
        d = feat.shape[1]
        tokens = feat.permute(0, 2, 3, 1).reshape(b, n * th * tw, d)
        pos = self.box_embedding(pos_masks, pe_name, tw) if m["USE_MULTI_POS"] else None
        key_pad = (~valid).repeat_interleave(th * tw, dim=1)
        out = self.encoder(tokens, name, layers, m["N_HEAD"], key_pad, pos)
        out = out.reshape(b * n, th, tw, d).permute(0, 3, 1, 2)
        out = self.deconv(self.deconv(out, "deconv_layers"), "deconv_layers")
        if res is not None:
            out = res + out
        heat = self.conv(out, "final_layer")
        heat = heat.reshape(b, n, *heat.shape[1:])
        return heat * valid[:, :, None, None, None].float()

    def transpose_h(self, x):
        """TransPose-H's features [P, C, H/4, W/4]: the trunk's branch 0
        reduced, then the intra encoder over its tokens with the sine table."""
        m = self.m
        feat = self.conv(self.trunk(x, "singleformer.")[m.get("HRNET_RES_LAYER", 0)],
                         "singleformer.reduce")
        p, d, fh, fw = feat.shape
        pe = torch.from_numpy(sine_table(fh, fw, d)).to(feat.device)
        tokens = feat.permute(0, 2, 3, 1).reshape(p, fh * fw, d)
        out = self.encoder(tokens, "singleformer.global_encoder", m["ENCODER_LAYERS"],
                           m["N_HEAD"], None, pe[None], INTRA_OFFSET_BASE)
        return out.reshape(p, fh, fw, d).permute(0, 3, 1, 2)


def _added_path(name: str) -> bool:
    """A BatchNorm scale whose output is added to another path: the last
    BatchNorm of a residual branch (``bn2`` of a basic block, ``bn3`` of a
    bottleneck) and every BatchNorm of a fusion path."""
    last = ((".branches." in name and name.endswith(("bn2.weight", "bn3.weight")))
            or (".layer1." in "." + name and name.endswith("bn3.weight")))
    return last or ".fuse_layers." in name


def seeded_params(names_shapes, seed: int, device) -> dict:
    """Float32 tensors for ``(name, shape)`` pairs from ``seed``, made on
    ``device`` in three draws: products' weights N(0, 1/fan_in), biases
    0.1 N(0, 1), other vectors (norm scales) 0.5 + U(0, 1), a tenth of that
    where the BatchNorm's output is added to another path; running means 0
    and variances 1 until :func:`calibrate` sets them.

    The tenth keeps the residual branches and fusions small, as trained
    residual networks have them (and as zero-initialised residual scales
    start them). Without it, the hundred calibrated BatchNorms of the W48
    trunk amplify rounding: its operands rounded to bfloat16 moved the
    heatmaps by 14% of their norm, and by 0.9% with it (the float32
    reference against itself rounded, on an H100)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [int(np.prod(s)) for _, s in names_shapes]
    total = sum(sizes)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    params, at = {}, 0
    for (name, shape), size in zip(names_shapes, sizes):
        z, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        if name.endswith("running_mean"):
            t = torch.zeros(shape, device=device)
        elif name.endswith("running_var"):
            t = torch.ones(shape, device=device)
        elif len(shape) > 1:
            t = z / math.sqrt(size / shape[0])
        elif name.endswith("bias"):
            t = 0.1 * z
        else:
            t = (0.5 + u) * (0.1 if _added_path(name) else 1.0)
        params[name] = t.clone()
    return params


@torch.no_grad()
def calibrate(params, cfg, seed: int, device, persons=(3, 2)) -> None:
    """Every BatchNorm's running statistics in ``params`` set to its batch
    statistics on seeded crops and box masks of ``len(persons)`` images,
    layer after layer, so that every layer's output is of order one."""
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    b, n = len(persons), max(persons)
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    images = torch.randn(b, n, h, w, 3, generator=g, device=device)
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    corner = torch.randint(0, min(h, w) // 2, (b, n, 2), generator=g, device=device)
    pos = ((yy >= corner[..., 0, None, None]) & (yy < corner[..., 0, None, None] + h // 2)
           & (xx >= corner[..., 1, None, None]) & (xx < corner[..., 1, None, None] + w // 2))
    valid = torch.arange(n, device=device)[None, :] < torch.tensor(persons, device=device)[:, None]
    net = Net(params, cfg)
    net.calibrate = True
    with exact_f32():
        net(images, pos.float()[..., None], valid)
