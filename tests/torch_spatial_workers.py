"""Rank side of tests/test_torch_spatial.py: the port's spatial (H-axis)
parallelism on four gloo ranks on the CPU, on a 2x2 and a 1x4
``("data", "spatial")`` mesh.  Imports nothing of JAX, so that the spawned
workers start quickly; the test process prepares the inputs, runs the
single-process and JAX references, and compares.

`run(rank, world, directory)` is the worker: it joins a gloo group on a
``file://`` store in ``directory``, reads ``inputs.pt`` there, forms both
meshes, runs every case of `CASES` and writes its results to
``rank{rank}.pt``.  A case returns tensors, arrays and numbers only.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ssdseglib_torch import losses
from ssdseglib_torch.config import EncodingConfig, ModelConfig
from ssdseglib_torch.data.pipeline import TrainDataLoader
from ssdseglib_torch.data.synthetic import generate_dataset
from ssdseglib_torch.models import blocks
from ssdseglib_torch.models.builder import ShuffleNetV2SsdSegBuilder, SsdSegModel
from ssdseglib_torch.models.fused_inference import make_fused_forward
from ssdseglib_torch.ops import depthwise_backward as dwb
from ssdseglib_torch.ops import fused_chain_backward as fcb
from ssdseglib_torch.parallel import mesh as mesh_lib
from ssdseglib_torch.parallel import spatial
from tests import torch_dp_workers as W

WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
STEP_BATCH = 8  # the JAX spatial test's batch: 2 a data group on 2x2
SERVE_NO_SUPPRESSION = dict(W.SERVE, use_segmentation_suppression=False)

# the op cases: an NCHW map of OP_SHAPE in f64, split 4 ways (12 rows a
# rank), with a 12-row halo allowed at output stride 1 so that the
# dilation-12 conv reads across three shards' worth of neighbours' rows at
# most one shard away; levels: 48 rows (split), 24 (split), 12 (split, 3 a
# rank), 6 (whole)
OP_SHAPE = (2, 3, 48, 32)
OP_HALOS = {1: 12}
OPS = {  # name: (input stride, kind, arguments)
    "conv3x3": (1, "conv", dict(kernel=3, stride=1, dilation=1)),
    "conv3x3_dilated12": (1, "conv", dict(kernel=3, stride=1, dilation=12)),
    "conv3x3_stride2": (1, "conv", dict(kernel=3, stride=2, dilation=1)),
    "conv3x3_stride2_to_whole": (4, "conv", dict(kernel=3, stride=2, dilation=1)),
    "conv5x5_stride2": (2, "conv", dict(kernel=5, stride=2, dilation=1)),
    "max_pool": (1, "pool", {}),
    "resize_x4": (4, "resize", dict(stride=1)),
    "resize_x2": (2, "resize", dict(stride=1)),
    "resize_from_whole": (8, "resize", dict(stride=2)),
    "mean_hw": (1, "mean", {}),
    "gather": (2, "whole", {}),
}


def op_input(stride: int, seed: int = 0) -> torch.Tensor:
    """The global f64 map of an op case at ``stride`` of OP_SHAPE."""
    b, c, h, w = OP_SHAPE
    rng = np.random.default_rng(seed + stride)
    return torch.from_numpy(rng.normal(size=(b, c, -(-h // stride), -(-w // stride))))


def op_weight(kernel: int) -> torch.Tensor:
    rng = np.random.default_rng(kernel)
    return torch.from_numpy(rng.normal(size=(4, OP_SHAPE[1], kernel, kernel)))


def apply_op(name: str, x: torch.Tensor) -> torch.Tensor:
    """The op of case ``name`` on ``x``: the global op outside a scope, this
    rank's part inside one with a row partition."""
    _, kind, args = OPS[name]
    if kind == "conv":
        return blocks.conv2d_same(x, op_weight(args["kernel"]), None, args["stride"],
                                  args["dilation"])
    if kind == "pool":
        return blocks.max_pool_same(x)
    if kind == "resize":
        b, c, h, w = OP_SHAPE
        return blocks.bilinear_resize(x, h // args["stride"], w // args["stride"])
    if kind == "mean":
        return spatial.mean_hw(x)
    return spatial.whole(x)


def _rows(t, n: int, rank: int, dim: int = 2):
    h = t.shape[dim] // n
    return t.narrow(dim, rank * h, h)


def case_ops(meshes, inputs, directory):
    """Each op of OPS on the 1x4 mesh, forward and backward in f64: this
    rank's output and input gradient for the upstream gradient
    ``inputs["op_grads"][name]`` (this rank's rows of it where the output is
    split, a quarter of it where it is whole: the ranks' shares of one
    objective), both split or whole as the partition makes them."""
    mesh = meshes["1x4"]
    rank = dist.get_rank(mesh.get_group(mesh_lib.SPATIAL_AXIS))
    b, c, h, w = OP_SHAPE
    partition = spatial.RowPartition(h, w, 4, rank, OP_HALOS)
    out = {"levels": partition.levels}
    with mesh_lib.data_parallel(mesh), mesh_lib.partitioned(partition):
        for name, (stride, _, _) in OPS.items():
            x = op_input(stride)
            split_in = partition.is_split(x.shape[2], x.shape[3])
            x = (_rows(x, 4, rank) if split_in else x).requires_grad_()
            y = apply_op(name, x)
            g = inputs["op_grads"][name]
            split_out = y.shape[2] * 4 == g.shape[2]
            (dx,) = torch.autograd.grad(y, x, _rows(g, 4, rank) if split_out else g / 4.0)
            out[name] = {"y": y.detach(), "dx": dx, "split_in": split_in,
                         "split_out": split_out}
    return out


def case_mesh(meshes, inputs, directory):
    out = {}
    for name, mesh in meshes.items():
        out[name] = {
            "shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "coordinate": mesh.get_coordinate(),
            "shard": tuple(spatial.shard_images(mesh, np.zeros((4, 96, 128, 3),
                                                               np.float32)).shape),
            "image_sharding": repr(spatial.image_sharding(mesh)),
            "batch_sharding": repr(mesh_lib.batch_sharding(mesh)),
            "rows": spatial.shard_images(
                mesh, np.arange(4 * 96, dtype=np.float32).reshape(4, 96, 1, 1))[:, :, 0, 0],
        }
    errors = {}
    for key, call in (
            ("batch", lambda: spatial.shard_images(meshes["2x2"], np.zeros((3, 96, 128, 3)))),
            ("height", lambda: spatial.shard_images(meshes["1x4"], np.zeros((2, 94, 128, 3)))),
            ("devices", lambda: spatial.make_hybrid_mesh(4, 4, device="cpu"))):
        try:
            call()
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    return out


def _serve(variables, mesh, builder=None, **overrides):
    model = SsdSegModel(ModelConfig(**(W.MODEL if builder is None else W.SHUFFLENET)),
                        torch.Generator().manual_seed(0))
    model.load_state_dict(variables)
    kwargs = {**W.SERVE, **overrides}
    return (builder or W.builder()).get_model_for_inference(model, device="cpu", mesh=mesh,
                                                            **kwargs)


def shufflenet_builder() -> ShuffleNetV2SsdSegBuilder:
    centroids = W.anchors().centroids
    return ShuffleNetV2SsdSegBuilder(
        W.MODEL["input_image_shape"], "0.5x", False, False, 4, 4, centroids[:, 0],
        centroids[:, 1], centroids[:, 2], centroids[:, 3], (0.1, 0.1, 0.2, 0.2))


def serving_cases(variables, shufflenet, images, mesh_of):
    """(name, model, images) of the serving cases: 2x2 at b4 with the
    segmentation suppression, 1x4 at b1 without, and ShuffleNetV2 0.5x on 1x4
    at b1; ``mesh_of(name)`` gives each its mesh (None: one process)."""
    return (("2x2_b4_suppression", _serve(variables, mesh_of("2x2")), images),
            ("1x4_b1", _serve(variables, mesh_of("1x4"), **SERVE_NO_SUPPRESSION), images[:1]),
            ("shufflenet_1x4_b1", _serve(shufflenet, mesh_of("1x4"), builder=shufflenet_builder(),
                                         **SERVE_NO_SUPPRESSION), images[:1]))


def case_serving(meshes, inputs, directory):
    out = {}
    for name, infer, images in serving_cases(inputs["variables"], inputs["shufflenet"],
                                              inputs["serve_images"], meshes.get):
        out[name] = infer.predict(images)
        out[name, "call"] = tuple(tuple(t.shape) for t in infer(images))
    # the must-miss variant: the halo rows left at zero
    zeros = spatial._swap

    def no_halo(first, last, group, rank, n):
        above, below = zeros(first, last, group, rank, n)
        return (None if above is None else torch.zeros_like(above),
                None if below is None else torch.zeros_like(below))

    spatial._swap = no_halo
    try:
        name, infer, images = serving_cases(inputs["variables"], inputs["shufflenet"],
                                            inputs["serve_images"], meshes.get)[0]
        out[name, "no_halo"] = infer.predict(images)
    finally:
        spatial._swap = zeros
    return out


def case_shift(meshes, inputs, directory):
    """f32 `predict` at b2 on 2x2 (one image a data group, its rows split
    in two) under ``set_depthwise_impl("shift")``."""
    blocks.set_depthwise_impl("shift")
    try:
        infer = _serve(inputs["variables"], meshes["2x2"], **SERVE_NO_SUPPRESSION)
        return {"predict": infer.predict(inputs["serve_images"][:2])}
    finally:
        blocks.set_depthwise_impl("conv")


def grads64(mesh, variables, images, targets):
    """The f64 gradient of one train-mode step's objective and its loss
    metrics, through the trainer's own pieces: the rows taken
    (`Trainer._own_rows`), the forward and losses inside the mesh's scope,
    and the gradient mean over the mesh (`Trainer._mean_gradients`).
    ``images``/``targets``: the global batch."""
    trainer = W.trainer(batch_size=STEP_BATCH)
    net = trainer._net.double().train()
    params = {k: variables[k].double().clone().requires_grad_() for k in trainer._param_names}
    stats = {k: variables[k].double().clone() for k in trainer._stat_names}
    images = torch.as_tensor(images).double()
    targets = {k: torch.as_tensor(v).double() for k, v in targets.items()}
    if mesh is not None:
        images, targets = mesh_lib.shard_batch(mesh, (images, targets))
    images, targets = trainer._own_rows(mesh, images, targets)
    with mesh_lib.data_parallel(mesh):
        outputs = functional_call(net, {**params, **stats}, (images,))
        total, metrics = trainer._losses_and_metrics(outputs, targets)
    names = trainer._param_names
    grads = torch.autograd.grad(total, [params[k] for k in names])
    if mesh is not None:
        grads = trainer._mean_gradients([params[k].detach() for k in names], grads,
                                        mesh_lib.mesh_group(mesh))
    return ({k: g.detach().clone() for k, g in zip(names, grads)},
            {k: float(v) for k, v in metrics.items()})


def case_step(meshes, inputs, directory):
    """One f32 step on 2x2 (the aten and the weight-gradient 'cuda' routes),
    the f64 gradient, and the f64 gradient and metrics with the spatial
    all-reduce of the mask losses skipped (the must-miss variant)."""
    mesh = meshes["2x2"]
    images, targets = inputs["batch"]
    out = {"f32": W.one_step(mesh, inputs["variables"], images, targets,
                             batch_size=STEP_BATCH),
           "f64": grads64(mesh, inputs["variables"], images, targets)}
    blocks.set_wgrad_impl("cuda")
    try:
        out["wgrad_cuda"] = W.one_step(mesh, inputs["variables"], images, targets,
                                       batch_size=STEP_BATCH)
    finally:
        blocks.set_wgrad_impl("aten")
    reduce = losses.sum_over_rows
    losses.sum_over_rows = lambda t: t
    try:
        out["local_mask_sums"] = grads64(mesh, inputs["variables"], images, targets)
    finally:
        losses.sum_over_rows = reduce
    return out


def fit_loader(mesh=None) -> TrainDataLoader:
    """The JAX spatial fit test's loader: 8 samples (seed 5), one batch of 8,
    no augmentation."""
    samples = generate_dataset(8, image_shape=W.IMAGE_SHAPE, seed=5)
    return TrainDataLoader(samples, W.anchors(), EncodingConfig(**W.ENCODING),
                           batch_size=STEP_BATCH, augmentation_horizontal_flip=False,
                           augmentation_rgb=False, shuffle=False, num_workers=2, device="cpu",
                           mesh=mesh)


def case_fit(meshes, inputs, directory):
    """`fit` on 2x2 over a loader built with the mesh, every image batch
    the step sees recorded as it leaves `shard_images`."""
    mesh = meshes["2x2"]
    from ssdseglib_torch import train as train_mod

    seen = []
    shard_images = mesh_lib.shard_images

    def spy(m, images, **kwargs):
        result = shard_images(m, images, **kwargs)
        seen.append({"axes": tuple(m.mesh_dim_names), "in": tuple(images.shape),
                     "out": tuple(result.shape)})
        return result

    train_mod.mesh_lib.shard_images = spy
    try:
        trainer = W.trainer(batch_size=STEP_BATCH)
        state = trainer.init_state(variables=inputs["variables"], mesh=mesh)
        state, history = trainer.fit(state, fit_loader(mesh), epochs=1, mesh=mesh,
                                     log_fn=lambda s: None)
    finally:
        train_mod.mesh_lib.shard_images = shard_images
    return {"history": history, "seen": seen, "step": state.step}


def fused_cases(variables, images, mesh_of):
    """(name, model, images) of the fused serving cases (the kernels' plain
    versions on the CPU): 1x4 at b1 without the suppression, and 2x2 at b4
    with it and int8 pointwise convs calibrated on the batch; ``mesh_of``
    as in `serving_cases`."""
    return (("fused_1x4_b1", _serve(variables, mesh_of("1x4"), fused_backbone=True,
                                    **SERVE_NO_SUPPRESSION), images[:1]),
            ("fused_int8_2x2_b4", _serve(variables, mesh_of("2x2"), fused_backbone=True,
                                         quantize_pointwise=True, calibration_images=images),
             images))


def raw_forward(variables, mesh, images, s2d_stem=False) -> dict:
    """`make_fused_forward`'s f32 outputs on ``images`` (the global batch):
    inside the mesh's scope on this rank's block of them, the mask's rows
    this rank's and the heads' outputs whole."""
    forward = make_fused_forward(ModelConfig(**W.MODEL), variables, torch.float32,
                                 device="cpu", s2d_stem=s2d_stem)
    if mesh is None:
        return forward(torch.as_tensor(images))
    with mesh_lib.data_parallel(mesh):
        return forward(spatial.shard_images(mesh, images))


def _mbconv_windows(variant):
    """`spatial.edge_window` with the MBConv's window (one row each side)
    replaced by a must-miss variant: 'same_at_inner_edges', the rank's own
    rows alone, so that the kernel pads SAME at an inner edge; 'pad_x', a
    zero row of x past the global border, so that the zero padding falls on
    x where the expanded tensor should be padded."""
    real = spatial.edge_window

    def window(x, before, after):
        got = real(x, before, after)
        if got is None or (before, after) != (1, 1):
            return got
        if variant == "same_at_inner_edges":
            return spatial.Window(x, 0, 0, got.own_first, got.own_first, got.height)
        rows, _ = spatial.window_rows(x, 3, 1, 1)
        return spatial.Window(rows, 1, 1, got.own_first - 1, got.own_first, got.height)

    return window


def case_fused(meshes, inputs, directory):
    """The fused serving cases' `predict` and `__call__` shapes, the raw
    outputs of the fused forward on 1x4 (default and ``s2d_stem='cuda'``),
    and the first case under the MBConv window's must-miss variants."""
    variables, images = inputs["variables"], inputs["serve_images"]
    out = {}
    for name, infer, batch in fused_cases(variables, images, meshes.get):
        out[name] = infer.predict(batch)
        out[name, "call"] = tuple(tuple(t.shape) for t in infer(batch))
    for name, s2d in (("raw", False), ("raw_s2d", "cuda")):
        out[name] = raw_forward(variables, meshes["1x4"], images[:1], s2d)
    real = spatial.edge_window
    for variant in ("same_at_inner_edges", "pad_x"):
        spatial.edge_window = _mbconv_windows(variant)
        try:
            _, infer, batch = fused_cases(variables, images, meshes.get)[0]
            out["mbconv_" + variant] = infer.predict(batch)
        finally:
            spatial.edge_window = real
    return out


@contextlib.contextmanager
def flagship_envelopes():
    """The depthwise and chain backward routes' envelopes read at the
    flagship's size: the reduced model's 96x128 input is 480x640 over 5 each
    way, so its maps are held to the envelope at 5x their rows and
    columns (block0-depthwise: 32 channels at 48x64 -> 240x320)."""
    dw, chain = dwb.pallas_bwd_applicable, fcb.chain_applicable
    dwb.pallas_bwd_applicable = lambda h, w, *rest: dw(5 * h, 5 * w, *rest)
    fcb.chain_applicable = lambda h, w, *rest: chain(5 * h, 5 * w, *rest)
    try:
        yield
    finally:
        dwb.pallas_bwd_applicable, fcb.chain_applicable = dw, chain


@contextlib.contextmanager
def backward_gate(route: str):
    """``set_depthwise_bwd_impl('cuda')`` or ``set_chain_bwd_impl('cuda')``
    (``route``: 'depthwise' or 'chain') under `flagship_envelopes`.  With
    both gates on, the chain takes the one layer inside both envelopes
    (block0-depthwise), so each gate is stepped alone."""
    gate = {"depthwise": blocks.set_depthwise_bwd_impl,
            "chain": blocks.set_chain_bwd_impl}[route]
    with flagship_envelopes():
        gate("cuda")
        try:
            yield
        finally:
            gate("aten")


@contextlib.contextmanager
def backward_fault(route: str):
    """A must-miss variant of the route's backward alone, its forward
    untouched: 'depthwise', the window's first and last rows of dx dropped,
    so that the halo rows' gradients never reach their owners; 'chain', du
    over every row of the window (``rows`` None), so that the halo rows
    carry -Bc - D xhat and the pixel count is the window's."""
    module, name = {"depthwise": (dwb, "depthwise3x3_backward"),
                    "chain": (fcb, "dw_bn_relu6_backward")}[route]
    real = getattr(module, name)

    def fault(*args):
        if route == "chain":
            return real(*args[:-1], None)
        dx, dk = real(*args)
        dx = dx.clone()
        dx[:, 0] = dx[:, -1] = 0
        return dx, dk

    fault.launches = fault.split_launches = 0
    setattr(module, name, fault)
    try:
        yield
    finally:
        setattr(module, name, real)


def case_kernel_step(meshes, inputs, directory):
    """One f32 step on 2x2 with each backward kernel's gate (the kernels'
    plain versions), the windows each unit ran on, and the must-miss
    variants: each route's backward broken alone (`backward_fault`), and the
    chain's statistics and sums over the data group alone."""
    mesh = meshes["2x2"]
    images, targets = inputs["batch"]
    out = {}
    for route, unit in (("depthwise", dwb._DepthwiseConv3x3FusedBwd),
                        ("chain", fcb._DwBnRelu6Chain)):
        shapes, real = [], unit.apply

        def spy(*args, real=real, shapes=shapes):
            shapes.append(tuple(args[0].shape))
            return real(*args)

        unit.apply = spy
        try:
            with backward_gate(route):
                out[route] = W.one_step(mesh, inputs["variables"], images, targets,
                                        batch_size=STEP_BATCH)
        finally:
            unit.apply = real
        out[route, "windows"] = shapes
        with backward_fault(route), backward_gate(route):
            out[route, "fault"] = W.one_step(mesh, inputs["variables"], images, targets,
                                             batch_size=STEP_BATCH)
    real_group = fcb.split_group
    fcb.split_group = lambda x: mesh_lib.active_groups().data
    try:
        with backward_gate("chain"):
            out["chain_data_group"] = W.one_step(mesh, inputs["variables"], images, targets,
                                                 batch_size=STEP_BATCH)
    finally:
        fcb.split_group = real_group
    return out


# (f): block0-depthwise's map at 480x640 (32 channels at 240x320, 2.46 M
# values) on the 1x4 mesh: a shard holds 60 rows, 614 k values, under the
# envelope's 1 M
ENVELOPE_MAP = (1, 32, 240, 320)


def case_envelopes(meshes, inputs, directory):
    """Each backward route's unit on a shard of ENVELOPE_MAP under the real
    envelope, on 1x4: the grad_fn of its output (the unit's, when the
    envelope read the global rows) and the input gradient's shape."""
    mesh = meshes["1x4"]
    rank = dist.get_rank(mesh.get_group(mesh_lib.SPATIAL_AXIS))
    b, c, h, w = ENVELOPE_MAP
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(b, c, h // 4, w))
                         ).float().contiguous(memory_format=torch.channels_last)
    torch.manual_seed(0)
    layers = {"depthwise": blocks.SameConv2d(c, c, 3, groups=c),
              "chain": blocks.DepthwiseConvBN(c, relu_max=6.0).train()}
    out = {}
    partition = spatial.RowPartition(h, w, 4, rank)
    for route, layer in layers.items():
        gate = {"depthwise": blocks.set_depthwise_bwd_impl,
                "chain": blocks.set_chain_bwd_impl}[route]
        gate("cuda")
        try:
            with mesh_lib.data_parallel(mesh), mesh_lib.partitioned(partition):
                xr = x.clone().requires_grad_()
                y = (blocks.depthwise_conv(layer, xr) if route == "depthwise" else layer(xr))
                (dx,) = torch.autograd.grad(y.sum(), xr)
        finally:
            gate("aten")
        out[route] = {"grad_fn": type(y.grad_fn).__name__, "dx": tuple(dx.shape),
                      "y": tuple(y.shape)}
    return out


CASES = {
    "mesh": case_mesh,
    "ops": case_ops,
    "serving": case_serving,
    "shift": case_shift,
    "step": case_step,
    "fit": case_fit,
    "fused": case_fused,
    "kernel_step": case_kernel_step,
    "envelopes": case_envelopes,
}


def run(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        meshes = {name: spatial.make_hybrid_mesh(*shape, device="cpu")
                  for name, shape in MESHES.items()}
        results = {name: case(meshes, inputs, directory) for name, case in CASES.items()}
        torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
