"""Cost accounting of an eager PyTorch step, op by op.

Counterpart of ``repro.launch.hlo_cost``, which walks the compiled HLO
of a JAX step.  Eager PyTorch has no HLO and no ``while`` loops whose
trip counts a walk must multiply in: every op runs, and this mode sees
each one as it runs (on tensors that hold no memory, in a dry run:
``launch.dryrun``), so nothing is under-counted.  ``OpCost`` is a
``TorchDispatchMode`` that runs a ``FlopCounterMode`` inside it, and its
``summary()`` has the keys of ``HloCost.summary()``:

* ``flops``: the ``FlopCounterMode`` total (matmuls, convolutions,
  attention);
* ``bytes``: each aten op's operand and result bytes (each operand once,
  then each result), views and metadata ops zero: the eager program's
  materialisation points, as one fusion is one pass in ``hlo_cost``;
* ``collectives``: count and link bytes by kind, with the link model of
  ``hlo_cost`` / ``dryrun.parse_collectives`` (ring algorithms, (n-1)/n
  taken as 1): all-reduce 2x the operand, all-gather result - operand,
  reduce-scatter operand - result, all-to-all and permute the operand;
  plus ``total_link_bytes``.  The port's collectives tell the mode their
  kind where they are issued (``sharding.collectives.observe``): a
  reduce-scatter done as an all-reduce counts as the all-reduce it moves.

``skip_byte_scopes`` names functions (``"module.path:function"``) whose
inner bytes are replaced by their operands and results, as a kernel
that keeps its tiles on chip moves them: the forward call's operands and
results once, and its backward (tagged on the autograd nodes the call
made) twice that, the inputs, outputs and their gradients.  The mode
sums both ways in one pass: ``summary()`` counts every op,
``summary(scoped=True)`` the named functions as kernels.  ``top(kind,
n)`` gives the largest contributors (with ``detail``), attributed to the
innermost function of the model code on the stack, or to the autograd
node whose backward ran the op.
"""

from __future__ import annotations

import collections
import importlib
import sys

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.sharding import collectives as C

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# ops that move no bytes of their own (allocation, aliasing, metadata)
_FREE = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
         torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
         torch.ops.aten.empty_strided.default,
         torch.ops.aten._unsafe_view.default,
         torch.ops.aten.lift_fresh.default, torch.ops.prim.device.default,
         torch.ops.aten._local_scalar_dense.default}

# stack frames that are the accounting's own, not the model's
_OWN = ("launch/op_cost.py", "sharding/collectives.py",
        "sharding/partition.py")

_TAG = "op_cost_scope"


def link_bytes(kind: str, operand: float, result: float) -> float:
    """A collective's bytes over the links of one rank (``hlo_cost``'s
    model)."""
    if kind == "all-reduce":
        return 2.0 * operand
    if kind == "all-gather":
        return max(result - operand, 0.0)
    if kind == "reduce-scatter":
        return max(operand - result, 0.0)
    return operand


def tally(ops) -> dict:
    """Count and link bytes by kind of collectives given as (kind,
    operand bytes, result bytes), and ``total_link_bytes``: the
    ``collectives`` of ``summary()``, as ``parse_collectives`` tallies
    the HLO's."""
    out = {k: {"count": 0, "bytes": 0.0} for k in KINDS}
    for kind, operand, result in ops:
        out[kind]["count"] += 1
        out[kind]["bytes"] += link_bytes(kind, operand, result)
    out["total_link_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _where() -> str:
    """The innermost function of the port's own code on the stack
    (``module.function``), or the autograd node running a backward."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(_OWN):
            mod = name.rsplit("repro_torch/", 1)[1][:-3].replace("/", ".")
            return f"{mod}.{f.f_code.co_name}:{f.f_lineno}"
        f = f.f_back
    node = torch._C._current_autograd_node()
    return f"backward {node.name()}" if node is not None else "?"


class OpCost(TorchDispatchMode):
    """``with OpCost() as cost: step(...)``, then ``cost.summary()``.

    ``detail`` keeps each op's contribution for ``top``;
    ``skip_byte_scopes`` as in the module docstring."""

    def __init__(self, detail: bool = False,
                 skip_byte_scopes: tuple[str, ...] = ()):
        super().__init__()
        self.detail = detail
        self.skip_byte_scopes = tuple(skip_byte_scopes)
        self.bytes = 0.0
        self.scoped_bytes = 0.0
        self.ops: list[tuple[str, int, int]] = []    # the collectives
        # (amount, kind, op, where, view): view "both" counts in either
        # summary, "ops" only op by op, "scoped" only with the scopes
        self.records: list[tuple[float, str, str, str, str]] = []
        self.flop_counter = FlopCounterMode(display=False)
        self._depth = 0
        self._patched: list[tuple[object, str, object]] = []

    # -- the modes ---------------------------------------------------------

    def __enter__(self):
        for scope in self.skip_byte_scopes:
            mod_name, fn_name = scope.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            self._patched.append((mod, fn_name, orig))
            setattr(mod, fn_name, self._scoped(scope, orig))
        C.OBSERVERS.append(self)
        self.flop_counter.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.flop_counter.__exit__(*exc)
        C.OBSERVERS.remove(self)
        for mod, fn_name, orig in reversed(self._patched):
            setattr(mod, fn_name, orig)
        self._patched.clear()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _FREE or getattr(func, "is_view", False):
            return out
        b = float(_nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out)))
        self.bytes += b
        inside = self._in_scope()
        if not inside:
            self.scoped_bytes += b
        if self.detail and b:
            self.records.append((b, "bytes", func.overloadpacket.__name__,
                                 _where(), "ops" if inside else "both"))
        return out

    def _in_scope(self) -> bool:
        if self._depth:
            return True
        node = torch._C._current_autograd_node()
        return node is not None and _TAG in node.metadata

    # -- what the port tells it --------------------------------------------

    def collective(self, kind: str, operand: int, result: int) -> None:
        """One collective of ``kind`` issued with ``operand`` bytes in and
        ``result`` bytes out (``sharding.collectives.observe``)."""
        self.ops.append((kind, operand, result))
        link = link_bytes(kind, operand, result)
        if self.detail and link:
            self.records.append((link, kind, kind, _where(), "both"))

    def _scoped(self, scope: str, fn):
        """``fn`` counted as one kernel: its operands and results, and
        twice that for its backward (see the module docstring)."""
        def run(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            b = float(_nbytes(ins) + _nbytes(outs))
            where = _where() if self.detail else ""
            self._kernel(b, scope, where)
            grads = [t for t in outs if t.requires_grad]
            if grads and torch.is_grad_enabled():
                _tag(grads, ins, scope)
                grads[0].register_hook(
                    lambda g: self._kernel(2.0 * b, f"{scope} backward",
                                           where))
            return out
        return run

    def _kernel(self, b: float, op: str, where: str) -> None:
        self.scoped_bytes += b
        if self.detail:
            self.records.append((b, "bytes", op, where, "scoped"))

    # -- results ------------------------------------------------------------

    def summary(self, scoped: bool = False) -> dict:
        """The counts with the keys of ``hlo_cost.HloCost.summary()``;
        ``scoped``: the ``skip_byte_scopes`` counted as kernels."""
        return {
            "flops": float(self.flop_counter.get_total_flops()),
            "bytes": self.scoped_bytes if scoped else self.bytes,
            "collectives": tally(self.ops),
        }

    def top(self, kind: str, n: int = 15,
            scoped: bool = False) -> list[tuple[float, str, str]]:
        """The ``n`` largest (amount, op, where) of ``kind`` (a collective
        kind, or "bytes"), summed over the ops of one op name and place;
        ``scoped``: the bytes as ``summary(scoped=True)`` counts them."""
        views = ("both", "scoped" if scoped else "ops")
        agg: collections.Counter = collections.Counter()
        for amount, k, op, where, view in self.records:
            if k == kind and view in views:
                agg[(op, where)] += amount
        return [(v, op, where) for (op, where), v in agg.most_common(n)]


def _tag(outs: list, ins: list, scope: str) -> None:
    """Mark the autograd nodes between ``outs`` and ``ins`` as the
    backward of ``scope``."""
    stop = {t.grad_fn for t in ins if t.grad_fn is not None}
    todo = [t.grad_fn for t in outs if t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in stop or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "AccumulateGrad":
            continue
        node.metadata[_TAG] = scope
        todo.extend(nxt for nxt, _ in node.next_functions)
