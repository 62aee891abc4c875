"""Serving artifacts on `torch.export`: the port of the JAX package's
`utils/export.py`.

Production-serving story: trace the serving graphs ONCE, ship the
serialized programs to the serving fleet, and run them there without the
Python model code. Shapes are static by design (config.py bucket
policy), so one artifact per (image_size, object bucket) is the natural
unit.

Artifact layout (one `.ivosx` file, JAX's layout with the port's own
format strings, so that each package refuses the other's files as an
unsupported format):

    IVOSX1\\n
    <manifest JSON, one line>\\n
    <the bytes of torch.export.save>

A bundle (`IVOSB1\\n`) concatenates one such blob per entry, in
sorted-name order, with their lengths in the manifest. The manifest pins
the torch version, the device the program was exported on, the inputs'
and outputs' shapes and dtypes and a caller-supplied config fingerprint,
so mismatches fail loudly at load time instead of at dispatch time.

The entry functions close over the model rather than registering it, so
the weights a graph reads become its constants and those it does not
read stay out of the file: a bundle holds each weight once, in the entry
that uses it.

The matching kernels are the custom ops `manet::global_matching`,
`manet::global_matching_int8` and `manet::local_matching`
(`ops/global_matching_cuda.py`, `ops/local_matching_cuda.py`): each
exported graph holds them as nodes, which launch the hand-written kernels
on the card and run the plain versions on the CPU. Importing this module
registers them, and it imports `models/` only inside the functions that
build entries, so a serving process that imports it alone can load and
run a bundle. An artifact runs on the device it was exported on;
`load_*(path, device=...)` moves it elsewhere through
`torch.export.passes.move_to_device_pass` (the counterpart of JAX's
cross-lowering: a build host without a card writes an artifact that the
card serves).
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.export.passes import move_to_device_pass

from cvpr2020_manet_tpu_torch.config import check_params_only
# registers the manet::* custom ops that exported graphs call
from cvpr2020_manet_tpu_torch.ops import (  # noqa: F401
    global_matching_cuda, local_matching_cuda)

_MAGIC = b"IVOSX1\n"
FORMAT = "ivosx-torch/1"
_BUNDLE_MAGIC = b"IVOSB1\n"
BUNDLE_FORMAT = "ivosx-torch-bundle/1"


# --------------------------------------------------------------------- #
# forward-step construction
# --------------------------------------------------------------------- #

def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _grid(image_size: Tuple[int, int], pad_to: int):
    """-> (padded height, padded width, feature height, feature width)."""
    h, w = image_size
    hp, wp = h + (-h) % pad_to, w + (-w) % pad_to
    return hp, wp, hp // 4, wp // 4


def _pad_image(image: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Zero-pad an (H, W, 3) image to (hp, wp, 3); aligned sizes skip the
    no-op pad, which keeps the traced graph free of it."""
    h, w = image.shape[:2]
    if (hp, wp) == (h, w):
        return image
    return F.pad(image, (0, 0, 0, wp - w, 0, hp - h))


def _background(hh: int, ww: int, o: int, device) -> torch.Tensor:
    """(hh, ww, O) f32 maps with every pixel on the background."""
    bg = torch.zeros((hh, ww, o), device=device)
    bg[..., 0] = 1.0
    return bg


def build_round_forward(model: nn.Module, image_size: Tuple[int, int],
                        num_objects: int, pad_to: int = 16):
    """-> (fn, example_args): the single-frame interaction-round core.

    One interaction round on one frame: feature extraction, interaction
    branch on the scribble rasters, memory aggregation (first round), and
    propagation (global/local matching + decoder) against the annotated
    frame itself.

    fn(image (H, W, 3) f32, pos_scr (h, w, O) f32, neg_scr (h, w, O) f32)
      -> per-pixel class probabilities (h, w, O) f32, at feature
      resolution of the PADDED image: h = (H + (-H) % pad_to) // 4
      (the manifest records image_size/pad_to/feature_stride so hosts
      can derive the scribble grid and crop outputs back to the image).
    """
    hp, wp, hh, ww = _grid(image_size, pad_to)
    o = num_objects + 1
    dev = _model_device(model)

    def fn(image, pos_scr, neg_scr):
        feat, emb = model.extract_features(_pad_image(image, hp, wp)[None])
        f0, e0 = feat[0], emb[0]
        bg = _background(hh, ww, o, image.device)
        int_feats, int_logits = model.interact(f0, pos_scr, neg_scr, bg)
        mem = model.aggregate_memory(int_feats, torch.zeros_like(int_feats),
                                     True)
        lab = int_logits.argmax(dim=-1)
        ref_onehot = F.one_hot(lab.reshape(-1), o).float()
        logits, _ = model.propagate(
            f0, e0, e0.reshape(-1, e0.shape[-1]), ref_onehot, None,
            torch.ones((hh, ww, o), device=image.device), e0, bg, mem,
            torch.ones((o,), device=image.device))
        return torch.softmax(logits, dim=-1)

    # a new tensor for each argument: torch.export takes arguments that
    # are one tensor object for one input
    return fn, (torch.zeros((*image_size, 3), device=dev),
                torch.zeros((hh, ww, o), device=dev),
                torch.zeros((hh, ww, o), device=dev))


def build_serving_fns(model: nn.Module, image_size: Tuple[int, int],
                      num_objects: int, pad_to: int = 16
                      ) -> Dict[str, Tuple[Callable, tuple]]:
    """name -> (fn, example_args): the per-frame serving loop, staged.

    A serving host drives the full interactive-VOS loop from these five
    graphs alone (no Python model code), keeping the state tensors
    (features, embeddings, matching memory, MA memory, masks) itself:

      extract(image (H,W,3))               -> feat (h,w,Cd), emb (h,w,Ce)
      interact(feat, pos, neg, prev_mask)  -> int_feats (O,h,w,Cma),
                                              probs (h,w,O)
      aggregate_first(int_feats)           -> memory (O,h,w,Cma)
      aggregate_update(int_feats, memory)  -> memory
      propagate(feat, emb, ref_emb (N,Ce), ref_onehot (N,O),
                gmap_prev, prev_emb, prev_mask, memory, obj_valid)
                                           -> probs (h,w,O), gmap (h,w,O)

    N (matching-memory rows) is one annotated frame's pixels (h*w); stack
    rounds by re-running propagate with min-fused gmap_prev, the policy
    engine/evaluator.py uses in 'min_fused' mode. `propagate` launches
    one global-matching kernel (kernel 1, or kernel 3 in the int8 mode)
    and one local-matching kernel, so a T-frame loop driven from a bundle
    launches each T - 1 times, where the Evaluator matches all of a
    round's frames in one global launch. All shapes static per artifact.
    """
    hp, wp, hh, ww = _grid(image_size, pad_to)
    o = num_objects + 1
    cfg = model.cfg
    cd, ce, cma = (cfg.decoder_channels, cfg.embedding_dim_padded,
                   cfg.ma_channels)
    dev = _model_device(model)

    def extract(image):
        feat, emb = model.extract_features(_pad_image(image, hp, wp)[None])
        return feat[0], emb[0]

    def interact(feat, pos_scr, neg_scr, prev_mask):
        int_feats, logits = model.interact(feat, pos_scr, neg_scr, prev_mask)
        return int_feats, torch.softmax(logits, dim=-1)

    def aggregate_first(int_feats):
        return model.aggregate_memory(int_feats, torch.zeros_like(int_feats),
                                      True)

    def aggregate_update(int_feats, memory):
        return model.aggregate_memory(int_feats, memory, False)

    def propagate(feat, emb, ref_emb, ref_onehot, gmap_prev, prev_emb,
                  prev_mask, memory, obj_valid):
        logits, gmap = model.propagate(
            feat, emb, ref_emb, ref_onehot, None, gmap_prev, prev_emb,
            prev_mask, memory, obj_valid)
        return torch.softmax(logits, dim=-1), gmap

    # a new tensor for every argument: torch.export takes arguments that
    # are one tensor object for one input
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    md = model.dtype                      # the embedding head's dtype too
    feat_s, emb_s = (hh, ww, cd), (hh, ww, ce)
    maps_s, mem_s = (hh, ww, o), (o, hh, ww, cma)
    return {
        "extract": (extract, (zeros((*image_size, 3)),)),
        "interact": (interact, (zeros(feat_s, md), zeros(maps_s),
                                zeros(maps_s), zeros(maps_s))),
        "aggregate_first": (aggregate_first, (zeros(mem_s, md),)),
        "aggregate_update": (aggregate_update, (zeros(mem_s, md),
                                                zeros(mem_s, md))),
        "propagate": (propagate, (
            zeros(feat_s, md), zeros(emb_s, md), zeros((hh * ww, ce), md),
            zeros((hh * ww, o)), zeros(maps_s), zeros(emb_s, md),
            zeros(maps_s), zeros(mem_s, md), torch.ones((o,), device=dev))),
    }


def wrap_raw_image(fn, example_args):
    """Image arg becomes RAW uint8 RGB; ImageNet normalization moves
    INSIDE the exported graph (the serving contract should not require
    the host to know the training-time transform, and uint8 frames are
    4x fewer upload bytes; the batch engine's device-side ingest)."""
    from cvpr2020_manet_tpu_torch.utils.ingest import preprocess_frames

    def wrapped(image, *rest):
        return fn(preprocess_frames(image), *rest)

    image = example_args[0]
    return wrapped, (torch.zeros(image.shape, dtype=torch.uint8,
                                 device=image.device), *example_args[1:])


def wrap_yuv420_image(fn, example_args):
    """Image arg becomes the video decoder's planar YUV 4:2:0 pair:
    y (H, W) + uv (H/2, W/2, 2) uint8, HALF the bytes of uint8 RGB, with
    the BT.601 inverse + ImageNet normalization inside the exported graph
    (utils/ingest.py)."""
    from cvpr2020_manet_tpu_torch.utils.ingest import preprocess_yuv420

    image = example_args[0]
    h, w = image.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 contract needs even dims, got {h}x{w}")

    def wrapped(y, uv, *rest):
        return fn(preprocess_yuv420(y, uv), *rest)

    u8 = dict(dtype=torch.uint8, device=image.device)
    return wrapped, (torch.zeros((h, w), **u8),
                     torch.zeros((h // 2, w // 2, 2), **u8),
                     *example_args[1:])


IMAGE_WRAPPERS = {"float32": None, "uint8": wrap_raw_image,
                   "yuv420": wrap_yuv420_image}


def _image_wrapper(image_format: str):
    if image_format not in IMAGE_WRAPPERS:
        raise ValueError(f"unknown image_format {image_format!r}")
    return IMAGE_WRAPPERS[image_format]


class _Entry(nn.Module):
    """The nn.Module torch.export takes: `fn` closes over the model, which
    is not registered here (see the module docstring)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(model: nn.Module, fn: Callable, example_args: tuple):
    """torch.export of fn on example_args, the model in eval mode and no
    autograd."""
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(_Entry(fn), example_args)
    finally:
        model.train(training)
    # the example inputs are zeros that the manifest describes; saved with
    # the program they would take as many bytes as its weights
    ep.example_inputs = None
    return ep


def export_forward(model: nn.Module, image_size: Tuple[int, int],
                   num_objects: int, *, pad_to: int = 16,
                   image_format: str = "uint8"):
    """Export the round-forward on the model's device ->
    torch.export.ExportedProgram.

    image_format: 'uint8' (default: raw RGB frames, normalized
    device-side), 'float32' (pre-normalized), or 'yuv420' (the decoder's
    planar pair, see wrap_yuv420_image). JAX's `raw_image`, the older
    boolean spelling of uint8-vs-float32, has no counterpart."""
    check_params_only(model.cfg, "export")
    wrap = _image_wrapper(image_format)
    fn, example_args = build_round_forward(model, image_size, num_objects,
                                           pad_to=pad_to)
    if wrap is not None:
        fn, example_args = wrap(fn, example_args)
    return _export(model, fn, example_args)


def export_serving_bundle(model: nn.Module, image_size: Tuple[int, int],
                          num_objects: int, *, pad_to: int = 16,
                          image_format: str = "uint8"):
    """Export every serving-loop stage -> {name: ExportedProgram}.

    image_format ('uint8' default / 'float32' / 'yuv420') sets the
    `extract` entry's frame contract, as in export_forward."""
    check_params_only(model.cfg, "export")
    wrap = _image_wrapper(image_format)
    fns = build_serving_fns(model, image_size, num_objects, pad_to=pad_to)
    if wrap is not None:
        fns = dict(fns, extract=wrap(*fns["extract"]))
    return {name: _export(model, fn, args)
            for name, (fn, args) in fns.items()}


# --------------------------------------------------------------------- #
# save / load
# --------------------------------------------------------------------- #

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _user_inputs(ep) -> list:
    """The (fake) tensors of an exported program's user inputs."""
    placeholders = {n.name: n for n in ep.graph.nodes
                    if n.op == "placeholder"}
    return [placeholders[name].meta["val"]
            for name in ep.graph_signature.user_inputs]


def _signature(ep) -> Dict[str, Any]:
    """The device and the user inputs' and outputs' [shape, dtype] of an
    exported program, from its graph's metadata."""
    inputs = _user_inputs(ep)
    output = next(n for n in ep.graph.nodes if n.op == "output")
    n_user = len(ep.graph_signature.user_outputs)
    outputs = [n.meta["val"] for n in output.args[0][-n_user:]]
    return {"device": inputs[0].device.type,
            "in_avals": [[list(t.shape), _dtype_name(t.dtype)]
                         for t in inputs],
            "out_avals": [[list(t.shape), _dtype_name(t.dtype)]
                          for t in outputs]}


def _merge_extra(manifest: Dict[str, Any],
                 extra: Optional[Dict[str, Any]]) -> None:
    """Merge caller metadata, refusing to clobber reserved keys (a
    clobbered 'format'/'entries'/... writes a file load_* cannot read)."""
    if not extra:
        return
    clash = sorted(set(extra) & set(manifest))
    if clash:
        raise ValueError(f"extra manifest keys collide with reserved "
                         f"keys: {clash}")
    manifest.update(extra)


def _serialize(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _write(path: str, magic: bytes, manifest: Dict[str, Any],
           blobs) -> Dict[str, Any]:
    # normalize (tuples -> lists) so the returned dict equals the loaded one
    manifest = json.loads(json.dumps(manifest, sort_keys=True))
    with open(path, "wb") as f:
        f.write(magic)
        f.write(json.dumps(manifest, sort_keys=True).encode() + b"\n")
        for blob in blobs:
            f.write(blob)
    return manifest


def save_artifact(exported, path: str,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write the .ivosx artifact; returns the manifest dict."""
    manifest = {"format": FORMAT, "torch_version": torch.__version__,
                **_signature(exported)}
    _merge_extra(manifest, extra)
    return _write(path, _MAGIC, manifest, [_serialize(exported)])


def _read_header(f, path: str, magic: bytes, fmt: str) -> Dict[str, Any]:
    got = f.read(len(magic))
    if got != magic:
        raise ValueError(f"{path}: not an {fmt} file (bad magic {got!r})")
    try:
        manifest = json.loads(f.readline())
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: corrupt manifest: {e}") from e
    if manifest.get("format") != fmt:
        raise ValueError(
            f"{path}: unsupported format {manifest.get('format')!r}")
    return manifest


def _deserialize(blob: bytes, what: str):
    try:
        return torch.export.load(io.BytesIO(blob))
    except Exception as e:                  # any failure: a corrupt blob
        raise ValueError(f"{what}: {e}") from e


def _placed(ep, device):
    """The program on `device` (None: where it was exported), moved with
    move_to_device_pass where that differs. -> (program, device)."""
    here = _user_inputs(ep)[0].device
    if device is None:
        return ep, here
    there = torch.device(device)
    if there.type == "cuda" and there.index is None:
        there = torch.device("cuda", torch.cuda.current_device())
    if there != here:
        ep = move_to_device_pass(ep, there)
    return ep, there


@dataclasses.dataclass(frozen=True)
class LoadedArtifact:
    """A deserialized serving artifact; calling it runs the embedded graph
    on `device` after checking the arguments against the manifest."""
    manifest: Dict[str, Any]
    exported: Any
    device: torch.device
    module: nn.Module

    def __call__(self, *args):
        want = self.manifest["in_avals"]
        if len(args) != len(want):
            raise ValueError(f"{len(args)} arguments, {len(want)} expected")
        for i, (a, (shape, dtype)) in enumerate(zip(args, want)):
            if (list(a.shape) != shape or _dtype_name(a.dtype) != dtype
                    or a.device.type != self.device.type):
                raise ValueError(
                    f"argument {i}: {list(a.shape)} {_dtype_name(a.dtype)} "
                    f"on {a.device}, expected {shape} {dtype} on "
                    f"{self.device}")
        with torch.no_grad():
            return self.module(*args)


def _loaded(manifest, ep, device) -> LoadedArtifact:
    ep, device = _placed(ep, device)
    return LoadedArtifact(manifest=manifest, exported=ep, device=device,
                          module=ep.module())


def load_artifact(path: str, device=None) -> LoadedArtifact:
    """Load an .ivosx artifact, on `device` (default: the device it was
    exported on)."""
    with open(path, "rb") as f:
        manifest = _read_header(f, path, _MAGIC, FORMAT)
        blob = f.read()
    ep = _deserialize(blob, f"{path}: corrupt export blob")
    return _loaded(manifest, ep, device)


# --------------------------------------------------------------------- #
# serving bundles (multiple named graphs in one file)
# --------------------------------------------------------------------- #

def save_bundle(exports: Dict[str, Any], path: str,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write named exports as one .ivosx bundle; returns the manifest."""
    names = sorted(exports)
    blobs = {n: _serialize(exports[n]) for n in names}
    manifest = {
        "format": BUNDLE_FORMAT,
        "torch_version": torch.__version__,
        "entries": {n: {"length": len(blobs[n]), **_signature(exports[n])}
                    for n in names},
    }
    _merge_extra(manifest, extra)
    return _write(path, _BUNDLE_MAGIC, manifest, [blobs[n] for n in names])


@dataclasses.dataclass(frozen=True)
class LoadedBundle:
    """A deserialized serving bundle: bundle['propagate'](*args)."""
    manifest: Dict[str, Any]
    _entries: Dict[str, LoadedArtifact]

    @property
    def names(self):
        return sorted(self._entries)

    def __getitem__(self, name: str) -> LoadedArtifact:
        return self._entries[name]


def load_bundle(path: str, device=None) -> LoadedBundle:
    """Load an .ivosx bundle, every entry on `device` (default: the device
    it was exported on)."""
    with open(path, "rb") as f:
        manifest = _read_header(f, path, _BUNDLE_MAGIC, BUNDLE_FORMAT)
        entries = {}
        for name in sorted(manifest["entries"]):
            entry = manifest["entries"][name]
            ep = _deserialize(f.read(entry["length"]),
                              f"{path}: corrupt blob for entry {name!r}")
            entries[name] = _loaded(entry, ep, device)
    return LoadedBundle(manifest=manifest, _entries=entries)
