"""Meta-device initialization: build a model and its optimizer without
allocating (port of ``dlrover_tpu/utils/meta_init.py``).

``jax.eval_shape`` is the reference's meta device; here it is
``torch.device("meta")``. ``on_meta`` runs code with every tensor it
makes on the meta device, whatever device the code names, and drops
the random generators it passes (a meta tensor holds no values), so an
init function or a whole train step written for the card runs on meta
unchanged: shapes and dtypes only, nothing allocated, nothing drawn.
``materialize_leaf_by_leaf`` then allocates leaf by leaf on the target
device and fills each from one explicit ``torch.Generator``;
``materialize_from_checkpoint`` loads a checkpoint straight into empty
tensors, with no init before it.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch.overrides import TorchFunctionMode

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.models.common import tree_leaves, tree_map

logger = get_logger("utils.meta_init")

META = torch.device("meta")
_MOVES = frozenset({torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.cpu})


def _is_device(value) -> bool:
    if isinstance(value, torch.device):
        return True
    if isinstance(value, str):
        try:
            torch.device(value)
        except RuntimeError:
            return False
        return True
    return False


class _OnMeta(TorchFunctionMode):
    """Every ``device=`` argument becomes meta (with ``keep_cpu``, one
    naming the CPU stays), every ``generator=`` is dropped, and a tensor
    moved anywhere stays on meta."""

    def __init__(self, keep_cpu: bool = False):
        super().__init__()
        self._keep_cpu = keep_cpu

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs and not (
                self._keep_cpu and kwargs["device"] is not None
                and torch.device(kwargs["device"]).type == "cpu"):
            kwargs["device"] = META
        if func in _MOVES:
            if func is not torch.Tensor.to:
                return args[0]
            args = tuple(META if i and _is_device(a) else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextmanager
def on_meta(all_factories: bool = True) -> Iterator[None]:
    """Run the body with every tensor it makes on the meta device.
    ``all_factories=False`` (a train step) leaves a factory that names
    no device, or the CPU, on the CPU, as the real code has it (an
    optimizer's ``step`` counter, a scalar kept on the host)."""
    if not all_factories:
        with _OnMeta(keep_cpu=True):
            yield
        return
    with torch.device(META), _OnMeta():
        yield


def abstract_init(init_fn: Callable, arg: Any = None) -> Any:
    """``init_fn(arg)`` on the meta device, allocating nothing: a params
    tree (a ``torch.Generator`` for ``arg`` by default, as the models'
    init functions take), or a ``TrainState`` with its optimizer for
    ``AccelerateResult.init_fn`` (``arg``: its seed). The counterpart of
    ``jax.eval_shape``."""
    if arg is None:
        arg = torch.Generator().manual_seed(0)
    with on_meta():
        return init_fn(arg)


def param_stats(abstract: Any) -> Dict[str, float]:
    """{"params": N, "bytes": B} of a meta tree (or of any tree: a
    ``TrainState`` counts its parameters)."""
    leaves = tree_leaves(getattr(abstract, "params", abstract))
    params = sum(math.prod(leaf.shape) for leaf in leaves)
    nbytes = sum(math.prod(leaf.shape) * leaf.element_size()
                 for leaf in leaves)
    return {"params": params, "bytes": nbytes}


def default_leaf_init(generator: torch.Generator,
                      leaf: torch.Tensor) -> torch.Tensor:
    """Fill ``leaf`` in place: a fan-in-scaled normal for matrices, zeros
    for vectors (the reference's stand-in initializer)."""
    with torch.no_grad():
        if leaf.dim() < 2:
            return leaf.zero_()
        scale = 1.0 / math.sqrt(leaf.shape[-2])
        draw = torch.randn(leaf.shape, generator=generator,
                           dtype=torch.float32, device=leaf.device)
        return leaf.copy_(draw * scale)


def materialize_leaf_by_leaf(
    abstract: Any,
    leaf_init: Callable[[torch.Generator, torch.Tensor],
                        torch.Tensor] = default_leaf_init,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> Any:
    """Allocate one leaf at a time on ``device`` (``to_empty`` for a
    module) and fill it by ``leaf_init(generator, empty_leaf)``: peak
    scratch is one leaf. ``generator``: on ``device`` (default: seeded
    0), drawn from in the leaves' sorted-key order."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if isinstance(abstract, torch.nn.Module):
        module = abstract.to_empty(device=device)
        for p in module.parameters():
            leaf_init(generator, p.data)
        return module

    def make(leaf):
        return leaf_init(generator, torch.empty(
            leaf.shape, dtype=leaf.dtype, device=device))

    return tree_map(make, abstract)


def materialize_from_checkpoint(ckpt_manager, abstract: Any,
                                optimizer: Callable,
                                device: DeviceLike = None,
                                layout=None):
    """The newest checkpoint of ``ckpt_manager``
    (``checkpoint.ElasticCheckpointManager``) loaded straight into
    empty tensors on ``device`` shaped as ``abstract`` (a meta params
    tree, e.g. ``abstract_init(init_fn)``), with ``optimizer`` (the
    ``OptimizerFn``) over them: a ``TrainState``, or None when no
    checkpoint exists. No init runs before the load. Over several
    ranks pass the step's ``layout`` (``AccelerateResult.layout``) and
    this rank's blocks as ``abstract`` (``abstract_init(result.init_fn,
    0)``)."""
    from dlrover_tpu_torch.parallel.accelerate import TrainState

    device = resolve_device(device)

    def empty(leaf):
        t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        return t.requires_grad_(t.is_floating_point())

    params = tree_map(empty, getattr(abstract, "params", abstract))
    state = TrainState(step=0, params=params,
                       opt_state=optimizer(tree_leaves(params)))
    out = ckpt_manager.restore(state, layout=layout)
    if out is None:
        return None
    logger.info("materialized step %d from the checkpoint", out["step"])
    return out["state"]
