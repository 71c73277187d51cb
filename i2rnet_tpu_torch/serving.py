"""Serving: the request program in process, and as an artifact a fresh process loads.

Port of ``i2rnet_tpu/serving.py``. The device program of a request
(:func:`make_serve_fn`) is the crop-warp and position masks of
``preprocess_inputs``, the model forward and a second forward on the flipped
crops averaged in, DARK decode to source pixels, padded persons zeroed.
:class:`Predictor` pads requests into static ``(B, N)`` person buckets,
chunks what does not fit and routes each row to the smallest bucket that
holds it; it serves either a model in this process or the programs of an
artifact. :class:`MicroBatcher` coalesces single-image requests into those
batches. :func:`boxes_to_person_meta` is the host request math, copied.

The artifact (``.i2rx``, :func:`export_predictor`, :func:`save_artifact`,
:func:`load_predictor`) ships a trained model as one file: per person bucket
the whole request program, weights included, as a ``torch.export``
``ExportedProgram``. The hand kernels are in it as the registered ops of
:mod:`i2rnet_tpu_torch.ops.cuda.library` (``i2r::masked_mhsa`` ...), so a
process that loads it needs ``torch``, ``numpy`` and this package (which
registers the ops and builds the kernels at their first launch), and never
the model code. Layout: the ``I2RX`` magic, a uint32 header length, a JSON
header, then the payloads, each the bytes of ``torch.export.save``. The
header keeps the JAX artifact's fields (model, dataset, joints,
``batch_images``, the bucket table, ``raw_hw``, ``image_size``,
``heatmap_size``, ``flip_test``) and adds ``torch_version``, ``device`` and
``kernels`` (the ``i2r::`` ops the programs call). Its ``format_version``
is this package's own (:data:`FORMAT_VERSION`): each package's reader
refuses the other's file. :meth:`Predictor.call_sharded` serves one static
batch data-parallel over a list of devices (the JAX ``call_sharded``): each
device runs its rows on a replica of the model, and the results come back
in row order.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import queue
import struct
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

import i2rnet_tpu_torch.ops.cuda  # noqa: F401  (registers the i2r:: ops the artifacts call)
from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.ops.decode import get_final_preds
from i2rnet_tpu_torch.ops.flip import flip_back
from i2rnet_tpu_torch.ops.preprocess import np_rotate_bound_resize_affine, preprocess_inputs
from i2rnet_tpu_torch.ops.transforms import np_get_affine_transform


def boxes_to_person_meta(boxes: Sequence[Sequence[float]],
                         image_size: Tuple[int, int],
                         scale_factor: float = 1.25):
    """Person boxes (x, y, w, h) -> (centers [n,2], scales [n,2],
    crop_affines [n,2,3], rects [n,4] x1y1x2y2 ramp bounds), as
    ``i2rnet_tpu/serving.py:42`` (reference ``lib/dataset/coco.py:175-196``)."""
    iw, ih = int(image_size[0]), int(image_size[1])
    aspect = iw / ih
    centers, scales, affines, rects = [], [], [], []
    for x, y, w, h in boxes:
        c = np.array([x + (w - 1) / 2, y + (h - 1) / 2], np.float32)
        x1i, y1i = np.trunc(x), np.trunc(y)
        x2i, y2i = np.trunc(x + w), np.trunc(y + h)
        rects.append([x1i - 1, y1i - 1, x2i + 1, y2i + 1])
        if w > aspect * h:
            h = w / aspect
        else:
            w = h * aspect
        s = np.array([w / 200.0, h / 200.0], np.float32) * scale_factor
        centers.append(c)
        scales.append(s)
        affines.append(np_get_affine_transform(c, s, 0.0, (iw, ih)))
    return (np.asarray(centers, np.float32), np.asarray(scales, np.float32),
            np.asarray(affines, np.float32), np.asarray(rects, np.float32))


def heatmap_program(cfg: Dict, model, flip_pairs):
    """``heatmaps(crops, pos_masks, person_valid) -> [B, N, K, h, w]``: the
    forward, and with ``TEST.FLIP_TEST`` a second forward on the flipped
    crops averaged in (reference ``lib/core/function.py:142-162``, without
    the HRNet 1px shift, as validate() never applies it). A model that
    returns a dict (the two-stage ``interformer``) is read at ``["multi"]``,
    as ``i2rnet_tpu/serving.py:120-124``. No grad mode is set inside."""
    test = cfg["TEST"]

    def forward(*args):
        out = model(*args)
        # the two-stage model's {"single", "multi"}: serve the inter stage's
        return out["multi"] if isinstance(out, dict) else out

    def heatmaps(crops, pos_masks, person_valid):
        heat = forward(crops, pos_masks, person_valid)
        if test["FLIP_TEST"]:
            heat_f = forward(crops.flip(-2), pos_masks.flip(-2), person_valid)
            with tracing.span("serve.post", device=heat):
                heat = (heat + flip_back(heat_f, flip_pairs or [])) * 0.5
        return heat

    return heatmaps


def _eval_program(cfg: Dict, model, flip_pairs):
    """``evaluate(crops, pos_masks, person_valid, centers, scales) -> (coords
    [B*N,K,2], maxvals [B*N,K,1])``: the eval protocol of
    ``core/train.py::make_eval_step`` -- :func:`heatmap_program`'s maps, DARK
    decode to source pixels, padded persons zeroed. No grad mode is set
    inside, so that ``torch.export`` can trace it."""
    heatmap_size = tuple(int(v) for v in cfg["MODEL"]["HEATMAP_SIZE"])
    test = cfg["TEST"]
    heatmaps = heatmap_program(cfg, model, flip_pairs)

    def evaluate(crops, pos_masks, person_valid, centers, scales):
        heat = heatmaps(crops, pos_masks, person_valid)
        b, n = heat.shape[:2]
        with tracing.span("serve.post", device=heat):
            coords, maxvals = get_final_preds(
                heat.reshape(b * n, *heat.shape[2:]), centers, scales,
                blur_kernel=int(test["BLUR_KERNEL"]), heatmap_size=heatmap_size,
                post_process=bool(test["POST_PROCESS"]))
            vmask = person_valid.reshape(b * n, 1, 1).float()
            return coords * vmask, maxvals * vmask

    return evaluate


def make_eval_fn(cfg: Dict, model, flip_pairs):
    """:func:`_eval_program` under ``torch.inference_mode``, for eager callers."""
    return torch.inference_mode()(_eval_program(cfg, model, flip_pairs))


def _serve_program(cfg: Dict, model, flip_pairs):
    """:func:`make_serve_fn`'s function without a grad mode, the form
    ``torch.export`` traces (a grad-mode context inside a traced function
    becomes a sub-graph of its own)."""
    image_size = tuple(int(v) for v in cfg["MODEL"]["IMAGE_SIZE"])
    evaluate = _eval_program(cfg, model, flip_pairs)

    def serve(images_u8, crop_affines, boxes, mask_affines, person_valid, centers, scales):
        # serving affines come from boxes and never rotate: the axis-aligned warp
        with tracing.span("serve.preprocess", device=images_u8):
            crops, pos_masks = preprocess_inputs(images_u8, crop_affines, boxes, mask_affines,
                                                 image_size, axis_aligned=True)
        return evaluate(crops, pos_masks, person_valid, centers, scales)

    return serve


def make_serve_fn(cfg: Dict, model, flip_pairs):
    """Returns ``serve(images_u8, crop_affines, boxes, mask_affines,
    person_valid, centers, scales) -> (coords [B*N,K,2], maxvals [B*N,K,1])``
    over tensors on the model's device, under ``torch.inference_mode``: the
    crop-warp and position masks of ``preprocess_inputs``, then
    :func:`_eval_program`. :func:`export_predictor` traces the same program
    without the grad mode (:class:`ServeModule`).

    Invalid person slots must carry non-singular (e.g. identity) affines: a
    zero matrix inverts to nan, and attention would carry the nan crop into
    the image's valid persons.
    """
    return torch.inference_mode()(_serve_program(cfg, model, flip_pairs))


class ServeModule(nn.Module):
    """The serve program as a module holding the model, the form
    ``torch.export`` takes (under ``torch.no_grad``): the model's parameters
    and buffers become the exported program's weights."""

    def __init__(self, cfg: Dict, model: nn.Module, flip_pairs):
        super().__init__()
        self.model = model
        self._serve = _serve_program(cfg, model, flip_pairs)

    def forward(self, images_u8, crop_affines, boxes, mask_affines, person_valid, centers,
                scales):
        return self._serve(images_u8, crop_affines, boxes, mask_affines, person_valid,
                           centers, scales)


def _header(cfg: Dict, batch_images: int, n_buckets, raw_hw) -> Dict:
    """The serving geometry of a config: the artifact header's fields that an
    in-process predictor has too."""
    m = cfg["MODEL"]
    ns = sorted({int(n) for n in n_buckets})
    return {"model_name": m["NAME"], "dataset": cfg["DATASET"]["DATASET"],
            "num_joints": int(m["NUM_JOINTS"]), "batch_images": int(batch_images),
            "n_bucket": ns[-1], "buckets": [{"n_bucket": n} for n in ns],
            "raw_hw": [int(raw_hw[0]), int(raw_hw[1])],
            "image_size": [int(v) for v in m["IMAGE_SIZE"]],
            "heatmap_size": [int(v) for v in m["HEATMAP_SIZE"]],
            "flip_test": bool(cfg["TEST"]["FLIP_TEST"])}


def _padded_args(b: int, n: int, raw_hw, device) -> List[torch.Tensor]:
    """The seven inputs of one static ``(b, n)`` call with no person: a black
    canvas, identity affines, no valid slot."""
    affs = torch.zeros(b, n, 2, 3)
    affs[..., 0, 0] = affs[..., 1, 1] = 1.0
    args = (torch.zeros(b, *raw_hw, 3, dtype=torch.uint8), affs, torch.zeros(b, n, 4),
            affs.clone(), torch.zeros(b, n, dtype=torch.bool), torch.zeros(b * n, 2),
            torch.ones(b * n, 2))
    return [a.to(device) for a in args]


@contextlib.contextmanager
def _kernel_switch(model: nn.Module, use_kernels: Optional[bool]):
    """Every ``use_kernels`` switch under ``model`` set for the ``with``
    block (``None``: left as it is), then restored."""
    saved = [(m, m.use_kernels) for m in model.modules() if hasattr(m, "use_kernels")]
    try:
        for m, value in saved:
            m.use_kernels = value if use_kernels is None else bool(use_kernels)
        yield
    finally:
        for m, value in saved:
            m.use_kernels = value


def export_predictor(cfg: Dict, model: nn.Module, batch_images: int, n_bucket,
                     raw_hw: Tuple[int, int], device=None,
                     use_kernels: Optional[bool] = None) -> Tuple[bytes, Dict]:
    """Export the serving program of ``model`` (weights loaded, eval mode, on
    ``device``: where it is when ``None``) once per person bucket; returns
    ``(payload, header)`` for :func:`save_artifact`.

    ``n_bucket`` is one person bucket or several (e.g. ``(2, 4, 7)``): one
    program each, at static shapes: images ``[B, rawH, rawW, 3]`` uint8,
    crop_affines ``[B, N, 2, 3]``, boxes ``[B, N, 4]``, mask_affines ``[B,
    N, 2, 3]``, person_valid ``[B, N]`` bool, centers and scales ``[B*N,
    2]``, with B ``batch_images`` and ``raw_hw`` (rawH, rawW) the uint8
    canvas. ``use_kernels`` sets the model's kernel switch for the export
    (``False``: a program of plain PyTorch only); ``None`` keeps its routes.
    The kernels' packed weights are made once here (the HRFormer blocks'
    ``prepare_export``) and travel as constants. The flip-test pairs are the
    dataset's of ``DATASET.DATASET`` (``registry.get_dataset_class``).
    """
    from i2rnet_tpu_torch.ops.cuda.library import graph_ops
    from i2rnet_tpu_torch.registry import get_dataset_class

    k = int(cfg["MODEL"]["NUM_JOINTS"])
    try:
        pairs = get_dataset_class(cfg["DATASET"]["DATASET"]).flip_pairs
        flip_pairs = [list(p) for p in pairs if p[0] < k and p[1] < k]
    except KeyError:
        if cfg["TEST"]["FLIP_TEST"]:
            raise  # flip-test averaging needs the dataset's joint pairing
        flip_pairs = []
    at = next(model.parameters()).device
    if device is not None and torch.device(device).type != at.type:
        raise ValueError(f"export_predictor: the model is on {at}, not {device}")
    b, (rh, rw) = int(batch_images), (int(raw_hw[0]), int(raw_hw[1]))
    ns = sorted({int(n) for n in (n_bucket if hasattr(n_bucket, "__iter__") else [n_bucket])})
    module = ServeModule(cfg, model, flip_pairs).eval()
    payloads, buckets, kernels, offset = [], [], set(), 0
    with torch.no_grad(), _kernel_switch(model, use_kernels):
        for m in model.modules():
            if hasattr(m, "prepare_export"):
                m.prepare_export(model.compute_dtype, at)
        for n in ns:
            ep = torch.export.export(module, tuple(_padded_args(b, n, (rh, rw), at)))
            kernels.update(graph_ops(ep.graph))
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            payloads.append(buf.getvalue())
            buckets.append({"n_bucket": n, "offset": offset, "length": len(payloads[-1])})
            offset += len(payloads[-1])
    header = {"format_version": FORMAT_VERSION, "torch_version": torch.__version__,
              **_header(cfg, b, ns, (rh, rw)), "buckets": buckets, "device": at.type,
              "kernels": sorted(kernels)}
    return b"".join(payloads), header


MAGIC = b"I2RX"
#: this package's artifact format; the JAX package writes 1
FORMAT_VERSION = "torch-export-1"


def save_artifact(path: str, payload: bytes, header: Dict) -> None:
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload)


def _read_artifact(path: str) -> Tuple[Dict, bytes]:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not an i2rx artifact (magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        payload = f.read()
    version = header.get("format_version")
    if version != FORMAT_VERSION:
        made_by = (f", written by the JAX package (jax {header['jax_version']}): load it with "
                   "i2rnet_tpu.serving" if "jax_version" in header else "")
        raise ValueError(f"{path}: unsupported artifact format {version!r}{made_by} (this "
                         f"package reads {FORMAT_VERSION!r})")
    return header, payload


class Predictor:
    """``predict(images, boxes_per_image)``: raw uint8 RGB images up to the
    ``raw_hw`` canvas plus per-image person boxes (x, y, w, h) -> one
    ``[n_i, K, 3]`` array (x, y, confidence in source pixels) per image.

    Each image's boxes are split into rows of at most ``max(n_buckets)``
    persons; each row goes to the smallest person bucket that holds it and
    runs in a static ``[batch_images, n]`` batch padded with invalid rows.
    The constructor serves ``model`` in this process (:func:`make_serve_fn`);
    :meth:`from_programs` (what :func:`load_predictor` returns) serves an
    artifact's programs, one per bucket. ``header`` holds the geometry.

    Tracing (:mod:`~i2rnet_tpu_torch.tracing`): ``predictor.predict`` (a new
    ``call`` id, the device's anchor) over ``predictor.route``,
    ``predictor.bucket_call`` (its ``bucket`` index) for each static call
    (``predictor.pack`` with its child ``predictor.h2d``, the program's
    spans, ``predictor.readback``) and ``predictor.assemble``; counters
    ``predictor.slots`` (B x n a bucket call), ``predictor.persons`` (valid
    boxes) and ``predictor.h2d_bytes``.
    """

    def __init__(self, model, cfg: Dict, flip_pairs, batch_images: int = 8,
                 n_buckets: Sequence[int] = (2, 4, 7), raw_hw: Tuple[int, int] = (480, 640)):
        self._setup(_header(cfg, batch_images, n_buckets, raw_hw),
                    make_serve_fn(cfg, model, flip_pairs), next(model.parameters()).device)
        # call_sharded's replica on another device: a copy of the model there
        self._replicate = lambda dev: make_serve_fn(cfg, copy.deepcopy(model).to(dev),
                                                    flip_pairs)

    @classmethod
    def from_programs(cls, header: Dict, programs: Sequence, device) -> "Predictor":
        """A predictor over one callable program per bucket of ``header``
        (its order), each taking and returning the serve function's tensors."""
        by_n = {int(bk["n_bucket"]): prog for bk, prog in zip(header["buckets"], programs)}
        self = cls.__new__(cls)
        # the program of the call's bucket, read off person_valid [B, n]
        self._setup(header, lambda *args: by_n[args[4].shape[1]](*args), torch.device(device))
        self.programs = by_n
        return self

    def _setup(self, header: Dict, serve, device) -> None:
        self.header = header
        self.serve = serve
        self.device = torch.empty(0, device=device).device
        self._replicas = {self.device: serve}
        self.image_size = tuple(header["image_size"])
        self.num_joints = int(header["num_joints"])
        self.batch_images = int(header["batch_images"])
        self.n_buckets = sorted(int(bk["n_bucket"]) for bk in header["buckets"])
        self.raw_hw = tuple(header["raw_hw"])

    def _bucket(self, m: int) -> int:
        return next(n for n in self.n_buckets if m <= n)

    def _call(self, args):
        with torch.inference_mode():
            return self.serve(*args)

    def call_raw(self, images_u8, crop_affines, boxes, mask_affines, person_valid, centers,
                 scales):
        """One static call at the largest bucket's shapes (arrays or tensors,
        moved to the device) -> ``(coords [B*N,K,2], maxvals [B*N,K,1])`` on
        the device. Invalid slots need non-singular affines (:func:`make_serve_fn`)."""
        args = (images_u8, crop_affines, boxes, mask_affines, person_valid, centers, scales)
        return self._call([torch.as_tensor(a).to(self.device) for a in args])

    def _replica(self, device: torch.device):
        if device not in self._replicas:
            if not hasattr(self, "_replicate"):
                raise ValueError(f"an artifact's programs serve on {self.device}, not {device}")
            self._replicas[device] = self._replicate(device)
        return self._replicas[device]

    def call_sharded(self, devices, *args):
        """Data-parallel serving: :meth:`call_raw`'s call with the batch rows
        of every argument split evenly over ``devices`` (images ``[B, ...]``
        and the person arrays ``[B, N, ...]`` by image, centers and scales
        ``[B*N, 2]`` by the same images' persons). Each device runs its rows
        on its replica (the model copied there once; the predictor's own
        device serves with its own model), and the results are concatenated
        in row order on the first device. A device may be named more than
        once. ``batch_images`` must divide by the number of devices, as in
        the JAX ``Predictor.call_sharded``."""
        devices = [torch.empty(0, device=d).device for d in devices]
        if not devices or self.batch_images % len(devices) != 0:
            raise ValueError(f"batch_images={self.batch_images} not divisible by "
                             f"{len(devices)} devices")
        parts = []
        with torch.inference_mode():
            for i, dev in enumerate(devices):
                rows = [torch.as_tensor(a).chunk(len(devices))[i].to(dev) for a in args]
                parts.append(self._replica(dev)(*rows))
        return tuple(torch.cat([p[j].to(devices[0]) for p in parts]) for j in range(2))

    def warmup(self) -> None:
        """Run every bucket once with no person, so the first request does not
        pay the kernels' build and the convolutions' algorithm choice."""
        for n in self.n_buckets:
            self._call(_padded_args(self.batch_images, n, self.raw_hw, self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pack(self, n: int, chunk) -> List[torch.Tensor]:
        """The seven inputs on the device of one static (B, n) call over
        ``chunk``: rows ``(image index, first box, image, boxes)`` of at most
        ``n`` boxes each, B rows at most, the rest padding."""
        with tracing.span("predictor.pack"):
            arrays = self._host_arrays(n, chunk)
            tracing.count("predictor.h2d_bytes", sum(a.nbytes for a in arrays))
            with tracing.span("predictor.h2d", device=self.device):
                return [torch.from_numpy(a).to(self.device, non_blocking=True) for a in arrays]

    def _host_arrays(self, n: int, chunk) -> Tuple[np.ndarray, ...]:
        """:meth:`pack`'s seven arrays on the host."""
        b, (rh, rw) = self.batch_images, self.raw_hw
        imgs = np.zeros((b, rh, rw, 3), np.uint8)
        # padded slots get IDENTITY affines: a zero affine's inverse is nan
        affs = np.zeros((b, n, 2, 3), np.float32)
        affs[..., 0, 0] = affs[..., 1, 1] = 1.0
        mask_affs = affs.copy()
        rects = np.zeros((b, n, 4), np.float32)
        valid = np.zeros((b, n), bool)
        cent = np.zeros((b * n, 2), np.float32)
        scal = np.ones((b * n, 2), np.float32)
        for r, (_, _, img, bxs) in enumerate(chunk):
            ih, iw = img.shape[:2]
            imgs[r, :ih, :iw] = img
            c, s, a, rect = boxes_to_person_meta(bxs, self.image_size)
            m = len(bxs)
            affs[r, :m] = a
            # position mask: the full image squeezed to the model input, with
            # the ramp bounds saturated where a box touches the border
            mask_affs[r, :] = np_rotate_bound_resize_affine(iw, ih, 0.0, *self.image_size)
            rect[:, 0] = np.where(rect[:, 0] <= -1, -1e9, rect[:, 0])
            rect[:, 1] = np.where(rect[:, 1] <= -1, -1e9, rect[:, 1])
            rect[:, 2] = np.where(rect[:, 2] >= iw, 1e9, rect[:, 2])
            rect[:, 3] = np.where(rect[:, 3] >= ih, 1e9, rect[:, 3])
            rects[r, :m] = rect
            valid[r, :m] = True
            cent[r * n:r * n + m] = c
            scal[r * n:r * n + m] = s
        return imgs, affs, rects, mask_affs, valid, cent, scal

    def _run(self, n: int, chunk) -> np.ndarray:
        """One static (B, n) call over ``chunk`` rows -> [B, n, K, 3] keypoints."""
        b = self.batch_images
        tracing.count("predictor.slots", b * n)
        tracing.count("predictor.persons", sum(len(row[3]) for row in chunk))
        coords, maxvals = self._call(self.pack(n, chunk))
        with tracing.span("predictor.readback", device=coords):
            kp = torch.cat([coords, maxvals], dim=-1).cpu().numpy()
        return kp.reshape(b, n, self.num_joints, 3)

    def predict(self, images: Sequence[np.ndarray],
                boxes_per_image: Sequence[Sequence[Sequence[float]]]) -> List[np.ndarray]:
        call = tracing.begin_call(self.device)
        with tracing.span("predictor.predict", call=call):
            if len(images) != len(boxes_per_image):
                raise ValueError("images and boxes_per_image length mismatch")
            with tracing.span("predictor.route"):
                rows_by_n = self._route(images, boxes_per_image)
            done = []
            for n, rows in rows_by_n.items():
                for j0 in range(0, len(rows), self.batch_images):
                    chunk = rows[j0:j0 + self.batch_images]
                    with tracing.span("predictor.bucket_call", bucket=len(done), n=n):
                        done.append((chunk, self._run(n, chunk)))
            with tracing.span("predictor.assemble"):
                parts: Dict[int, list] = {}
                for chunk, kp in done:
                    for r, (i, start, _, bxs) in enumerate(chunk):
                        parts.setdefault(i, []).append((start, kp[r, :len(bxs)]))
                return [np.concatenate([k for _, k in sorted(parts[i], key=lambda t: t[0])],
                                       axis=0) for i in range(len(images))]

    def _route(self, images, boxes_per_image) -> Dict[int, list]:
        """Each image's boxes in rows of at most the largest bucket, each row
        under the smallest bucket that holds it; raises on a bad image."""
        rh, rw = self.raw_hw
        n_max = self.n_buckets[-1]
        rows_by_n: Dict[int, list] = {n: [] for n in self.n_buckets}
        for i, (img, bxs) in enumerate(zip(images, boxes_per_image)):
            img = np.asarray(img)
            if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
                raise ValueError(f"image {i}: expected uint8 HxWx3, got {img.dtype} {img.shape}")
            if img.shape[0] > rh or img.shape[1] > rw:
                raise ValueError(f"image {i}: {img.shape[:2]} exceeds the canvas {(rh, rw)}")
            bxs = list(bxs) or [[0, 0, img.shape[1], img.shape[0]]]
            for j in range(0, len(bxs), n_max):
                part = bxs[j:j + n_max]
                rows_by_n[self._bucket(len(part))].append((i, j, img, part))
        return rows_by_n


class MicroBatcher:
    """Coalesce concurrent single-image requests into full device batches.

    ``submit(image, boxes)`` returns a ``concurrent.futures.Future``; a
    background thread drains the queue, waiting up to ``max_delay_ms`` after
    the first pending request to gather ``predictor.batch_images`` of them
    before it dispatches one ``predict`` call. A failed call sets its
    exception on every waiter of that call. ``close()`` dispatches what is
    pending, then stops the thread; ``submit`` raises after it.

    Tracing (:mod:`~i2rnet_tpu_torch.tracing`): each request gets a ``request``
    id and its submit time; each call records ``batcher.gather`` (from its
    first request to the last pulled off the queue), ``batcher.handover``
    (from handing the call to ``predict`` to the program's ``predict``
    beginning: nothing in itself, the time of whatever wraps ``predict``),
    ``batcher.resolve`` (results set, callbacks included) and, per request,
    ``batcher.queue_wait`` (submit to the start of its call's ``predict``,
    with that call's ``call`` id); counter ``batcher.cut_short`` (calls
    sent under ``batch_images`` because the deadline ran out).
    """

    def __init__(self, predictor: Predictor, max_delay_ms: float = 5.0):
        self._pred = predictor
        self._delay = max_delay_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, boxes: Sequence[Sequence[float]]) -> Future:
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((image, boxes, fut, tracing.request()))
        return fut

    def close(self) -> None:
        self._closed = True
        self._q.put(None)  # wake the worker: it dispatches what came before, then stops
        self._thread.join()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            with tracing.span("batcher.gather"):
                group, closing = self._gather(item)
            self._dispatch(group, cut_short=not closing and len(group) < self._pred.batch_images)
            if closing:
                return

    def _gather(self, first):
        """Requests after ``first`` until ``batch_images`` or the deadline;
        returns ``(group, closing)``, ``closing`` where ``close()`` came."""
        group = [first]
        deadline = time.monotonic() + self._delay
        while len(group) < self._pred.batch_images:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                return group, True
            group.append(nxt)
        return group, False

    def _dispatch(self, group, cut_short: bool = False) -> None:
        handed = time.time_ns()
        try:
            results = self._pred.predict([g[0] for g in group], [g[1] for g in group])
        except Exception as e:  # every waiter of this call gets the error
            for _, _, fut, _ in group:
                fut.set_exception(e)
            return
        call, started = tracing.last_call()
        if started is not None and started >= handed and tracing.recording():
            tracing.record("batcher.handover", handed, started, call=call)
            for _, _, _, (request, submitted) in group:
                tracing.record("batcher.queue_wait", submitted, started, request=request,
                               call=call)
        with tracing.span("batcher.resolve", call=call):
            for (_, _, fut, _), res in zip(group, results):
                fut.set_result(res)
        if cut_short:
            tracing.count("batcher.cut_short")


def load_predictor(path: str, device=None) -> Predictor:
    """The :class:`Predictor` of an artifact, on ``device`` (the card when
    ``None``), which must be the device it was exported for: there is no
    fallback to another. Loading needs no model code; the programs call the
    kernels through the ``i2r::`` ops this package registers."""
    device = torch.device(device if device is not None else "cuda")
    header, payload = _read_artifact(path)
    if header["device"] != device.type:
        raise ValueError(f"{path}: exported for {header['device']!r}, asked to serve on "
                         f"{device.type!r}")
    progs = [torch.export.load(io.BytesIO(payload[bk["offset"]:bk["offset"] + bk["length"]]))
             .module() for bk in header["buckets"]]
    return Predictor.from_programs(header, progs, device)
