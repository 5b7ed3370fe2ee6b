"""TF1 GraphDef -> PyTorch evaluator for the InceptionV3 metrics backend
(counterpart of vaw_tpu/evals/tf_graph.py; reference: evaluations/
evaluator.py:574-620).

The reference runs OpenAI's frozen TF1 InceptionV3 graph in a TF session.
``GraphDefFunction`` evaluates the same frozen graph with torch ops on one
device: constants become tensors there, made once, and each node becomes a
torch call, in the graph's NHWC layout at the feeds and fetches. The graph
is read by ``graphdef.py``, with no TensorFlow.

TF1 semantics that torch does not reproduce are written out:

- ``ResizeBilinear`` uses the legacy sampling src = dst * in/out (or
  (in - 1)/(out - 1) with align_corners), no half-pixel offset, edge clamp;
- ``SAME`` padding of convs and pools puts the odd row and column at the
  bottom and right; ``AvgPool`` with ``SAME`` divides by the count of
  valid cells under each window;
- ``BatchNormWithGlobalNormalization`` (scale_after_normalization) and the
  old-style ``Concat``, whose axis is its first input;
- constants given by one value broadcast to their shape (``graphdef``).

Convolutions and matmuls run in f32 with TF32 off (``fid.full_f32``), as
the JAX compiler accumulates in f32. An op outside ``SUPPORTED_OPS`` raises
``NotImplementedError`` naming it when the graph is run; there is no other
backend to fall back to. Intermediate values are freed as soon as their
last consumer has run.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .fid import full_f32
from .graphdef import AttrValue, GraphDef, NodeDef

__all__ = ["GraphDefFunction", "SUPPORTED_OPS"]

_TORCH_DTYPES = {1: torch.float32, 2: torch.float64, 3: torch.int32, 4: torch.uint8,
                 5: torch.int16, 6: torch.int8, 9: torch.int64, 10: torch.bool,
                 19: torch.float16}

_NHWC = AttrValue(s=b"NHWC")
_ELEMWISE = {"Add": torch.add, "AddV2": torch.add, "Sub": torch.sub, "Mul": torch.mul,
             "RealDiv": torch.div, "Maximum": torch.maximum, "Minimum": torch.minimum}

# The ops of vaw_tpu/evals/tf_graph.py:SUPPORTED_OPS, the same set.
SUPPORTED_OPS = frozenset(list(_ELEMWISE) + [
    "Const", "Identity", "CheckNumerics", "StopGradient", "PlaceholderWithDefault",
    "BiasAdd", "Relu", "Relu6", "Rsqrt", "Sqrt", "Square", "Neg", "Softmax", "Conv2D",
    "MaxPool", "AvgPool", "BatchNormWithGlobalNormalization", "FusedBatchNorm",
    "FusedBatchNormV3", "Concat", "ConcatV2", "Reshape", "ExpandDims", "Squeeze", "Cast",
    "MatMul", "ResizeBilinear", "Pad", "Shape", "Mean",
])


def _ref(name: str) -> Tuple[str, int]:
    """'node:2' -> ('node', 2)."""
    if ":" in name:
        base, idx = name.rsplit(":", 1)
        return base, int(idx)
    return name, 0


def _ints(x) -> List[int]:
    """A shape-feeding value (a numpy constant or a tensor) as ints."""
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.reshape(-1).tolist()]
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF's SAME padding of one axis: the odd cell after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x, node: NodeDef, kh: int, kw: int, sh: int, sw: int):
    """F.pad's (left, right, top, bottom) for NCHW x under the node's
    padding attr."""
    padding = node.attr["padding"].s.decode()
    if padding == "VALID":
        return (0, 0, 0, 0)
    if padding != "SAME":
        raise NotImplementedError(f"padding {padding!r} (node '{node.name}')")
    top, bottom = _same_pads(x.shape[2], kh, sh)
    left, right = _same_pads(x.shape[3], kw, sw)
    return (left, right, top, bottom)


def _conv2d(x, w, node: NodeDef):
    """NHWC x, HWIO w."""
    strides = node.attr["strides"].list.i
    sh, sw = strides[1], strides[2]
    xc = x.float().permute(0, 3, 1, 2)
    wc = w.float().permute(3, 2, 0, 1)
    xc = F.pad(xc, _pads(xc, node, wc.shape[2], wc.shape[3], sh, sw))
    with full_f32():
        y = F.conv2d(xc, wc, stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


def _pool(x, node: NodeDef, avg: bool):
    ksize, strides = node.attr["ksize"].list.i, node.attr["strides"].list.i
    if ksize[0] != 1 or ksize[3] != 1 or strides[0] != 1 or strides[3] != 1:
        raise NotImplementedError(f"pooling over batch or channels (node '{node.name}')")
    k, s = (ksize[1], ksize[2]), (strides[1], strides[2])
    xc = x.float().permute(0, 3, 1, 2)
    pads = _pads(xc, node, k[0], k[1], s[0], s[1])
    if not avg:
        y = F.max_pool2d(F.pad(xc, pads, value=-float("inf")), k, s)
    else:
        # Window sums over zero padding, over the count of valid cells.
        y = F.avg_pool2d(F.pad(xc, pads), k, s, divisor_override=1)
        ones = F.pad(torch.ones_like(xc[:1, :1]), pads)
        y = y / F.avg_pool2d(ones, k, s, divisor_override=1)
    return y.permute(0, 2, 3, 1)


def _resize_bilinear_tf1(x, out_hw, align_corners: bool):
    """Legacy TF1 ResizeBilinear of NHWC x (vaw_tpu/evals/tf_graph.py:
    103-134): float source coordinates src = dst * scale, scale = in/out
    (or (in-1)/(out-1) with align_corners), edge clamp, bilinear lerp."""
    _, in_h, in_w, _ = x.shape

    def axis(in_sz, out_sz):
        scale = ((in_sz - 1) / (out_sz - 1) if align_corners and out_sz > 1
                 else in_sz / out_sz)
        src = np.arange(out_sz, dtype=np.float64) * scale
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_sz - 1)
        hi = np.clip(lo + 1, 0, in_sz - 1)
        frac = (src - lo).astype(np.float32)
        put = lambda a: torch.as_tensor(a, device=x.device)  # noqa: E731
        return put(lo), put(hi), put(frac)

    h_lo, h_hi, h_frac = axis(in_h, int(out_hw[0]))
    w_lo, w_hi, w_frac = axis(in_w, int(out_hw[1]))
    x = x.float()
    top, bot = x[:, h_lo], x[:, h_hi]
    rows = top + (bot - top) * h_frac[None, :, None, None]
    left, right = rows[:, :, w_lo], rows[:, :, w_hi]
    return left + (right - left) * w_frac[None, None, :, None]


def _flag(node: NodeDef, key: str) -> bool:
    """A bool attr, False where the node does not set it."""
    return key in node.attr and node.attr[key].b


def _matmul(a, b, node: NodeDef):
    if _flag(node, "transpose_a"):
        a = a.T
    if _flag(node, "transpose_b"):
        b = b.T
    with full_f32():
        return a.float() @ b.float()


def _batch_norm_global(ins, node: NodeDef):
    x, m, v, beta, gamma = (t.float() for t in ins)
    inv = torch.rsqrt(v + node.attr["variance_epsilon"].f)
    if node.attr["scale_after_normalization"].b:
        inv = inv * gamma
    return x * inv + (beta - m * inv)


class GraphDefFunction:
    """Named output tensors of a frozen GraphDef as a torch function on
    `device`.

    feeds: tensor refs (e.g. "ExpandDims:0") that take the positional
    arguments, as tf.import_graph_def's input_map
    (reference: evaluations/evaluator.py:591-597); fetches: the tensor refs
    returned (one tensor, or a tuple of them).
    """

    def __init__(self, graph_def: GraphDef, feeds: Sequence[str], fetches: Sequence[str],
                 device="cpu"):
        self.nodes: Dict[str, NodeDef] = {n.name: n for n in graph_def.node}
        self.feeds = [_ref(f) for f in feeds]
        self.fetches = [_ref(f) for f in fetches]
        self.device = torch.device(device)
        for name, _ in self.feeds + self.fetches:
            if name not in self.nodes:
                raise KeyError(f"node '{name}' not in graph")
        self._numpy: Dict[str, np.ndarray] = {}
        self._tensors: Dict[str, torch.Tensor] = {}
        self._order, self._uses = self._plan()

    def const(self, name: str) -> np.ndarray:
        """A Const node's value (e.g. the softmax weight matrix,
        reference: evaluations/evaluator.py:613-620)."""
        node = self.nodes[_ref(name)[0]]
        if node.op != "Const":
            raise ValueError(f"node '{node.name}' is a {node.op}, not a Const")
        if node.name not in self._numpy:
            self._numpy[node.name] = node.attr["value"].tensor.numpy()
        return self._numpy[node.name]

    def const_tensor(self, name: str) -> torch.Tensor:
        """A Const node's value on the device, made once."""
        return self._operand(name, self.const(name))

    def _operand(self, name: str, value):
        """An input as a tensor: a constant (numpy, from a Const node or
        passed on by an Identity) goes to the device once, cached by the
        name of the node that gave it."""
        if not isinstance(value, np.ndarray):
            return value
        if name not in self._tensors:
            self._tensors[name] = torch.tensor(value, device=self.device)
        return self._tensors[name]

    def _plan(self):
        """The nodes the fetches need, in an order where each follows its
        inputs (the feeds cut the graph), and the uses of each value."""
        feeds = set(self.feeds)
        order, state = [], {}
        uses: Dict[Tuple[str, int], int] = {}
        for root in self.fetches:
            if root in feeds:
                continue
            stack = [(root[0], False)]
            while stack:
                name, done = stack.pop()
                if done:
                    if state.get(name) != 2:
                        state[name] = 2
                        order.append(name)
                    continue
                if state.get(name):
                    continue
                state[name] = 1
                stack.append((name, True))
                for inp in self.nodes[name].input:
                    if inp.startswith("^"):
                        continue
                    ref = _ref(inp)
                    if ref not in feeds and not state.get(ref[0]):
                        stack.append((ref[0], False))
        for name in order:
            for inp in self.nodes[name].input:
                if not inp.startswith("^"):
                    uses[_ref(inp)] = uses.get(_ref(inp), 0) + 1
        return order, uses

    def __call__(self, *args):
        if len(args) != len(self.feeds):
            raise TypeError(f"{len(self.feeds)} feeds, got {len(args)} arguments")
        memo = {ref: (a if isinstance(a, torch.Tensor)
                      else torch.as_tensor(np.array(a), device=self.device))
                for ref, a in zip(self.feeds, args)}
        left = dict(self._uses)
        keep = set(self.fetches)
        for name in self._order:
            node = self.nodes[name]
            refs = [_ref(i) for i in node.input if not i.startswith("^")]
            outs = self._eval_node(node, refs, [memo[r] for r in refs])
            if not isinstance(outs, tuple):
                outs = (outs,)
            for j, out in enumerate(outs):
                memo[(name, j)] = out
            for r in refs:
                left[r] -= 1
                if not left[r] and r not in keep:
                    del memo[r]
        results = tuple(memo[r] for r in self.fetches)
        return results[0] if len(results) == 1 else results

    def _eval_node(self, node: NodeDef, refs, ins):
        op = node.op
        if op == "Const":
            # Kept as numpy: shape-feeding constants (resize sizes, concat
            # axes, reshape targets) are read on the host; an operand
            # becomes a device tensor where it is used, made once.
            return self.const(node.name)
        if op not in SUPPORTED_OPS:
            raise NotImplementedError(
                f"GraphDef op '{op}' (node '{node.name}') not supported")
        if op in ("Identity", "CheckNumerics", "StopGradient", "PlaceholderWithDefault"):
            return ins[0]
        if node.attr.get("data_format", _NHWC).s not in (b"", b"NHWC"):
            raise NotImplementedError(f"data_format {node.attr['data_format'].s!r} "
                                      f"(node '{node.name}')")
        ts = [self._operand(r[0], v) for r, v in zip(refs, ins)]
        if op in _ELEMWISE:
            return _ELEMWISE[op](ts[0], ts[1])
        if op == "BiasAdd":
            return ts[0] + ts[1]
        if op == "Relu":
            return torch.relu(ts[0])
        if op == "Relu6":
            return torch.clamp(ts[0], 0, 6)
        if op == "Rsqrt":
            return torch.rsqrt(ts[0].float())
        if op == "Sqrt":
            return torch.sqrt(ts[0].float())
        if op == "Square":
            return ts[0] * ts[0]
        if op == "Neg":
            return -ts[0]
        if op == "Softmax":
            return torch.softmax(ts[0].float(), dim=-1)
        if op == "Conv2D":
            return _conv2d(ts[0], ts[1], node)
        if op in ("MaxPool", "AvgPool"):
            return _pool(ts[0], node, avg=op == "AvgPool")
        if op == "BatchNormWithGlobalNormalization":
            return _batch_norm_global(ts, node)
        if op in ("FusedBatchNorm", "FusedBatchNormV3"):
            x, gamma, beta, m, v = (t.float() for t in ts)
            inv = torch.rsqrt(v + node.attr["epsilon"].f) * gamma
            return (x * inv + (beta - m * inv),)
        if op == "Concat":  # old style: the axis is the first input
            return torch.cat(ts[1:], dim=_ints(ins[0])[0])
        if op == "ConcatV2":  # the axis is the last input
            return torch.cat(ts[:-1], dim=_ints(ins[-1])[0])
        if op == "Reshape":
            return ts[0].reshape(_ints(ins[1]))
        if op == "ExpandDims":
            return ts[0].unsqueeze(_ints(ins[1])[0])
        if op == "Squeeze":
            dims = node.attr["squeeze_dims"].list.i if "squeeze_dims" in node.attr else []
            if not dims:
                return ts[0].squeeze()
            return ts[0].squeeze(tuple(d % ts[0].dim() for d in dims))
        if op == "Cast":
            return ts[0].to(_TORCH_DTYPES[node.attr["DstT"].type])
        if op == "MatMul":
            return _matmul(ts[0], ts[1], node)
        if op == "ResizeBilinear":
            return _resize_bilinear_tf1(ts[0], _ints(ins[1]), _flag(node, "align_corners"))
        if op == "Pad":
            pads = np.asarray(_ints(ins[1])).reshape(-1, 2)
            return F.pad(ts[0], [int(v) for pair in pads[::-1] for v in pair])
        if op == "Shape":
            return torch.tensor(list(ts[0].shape), dtype=torch.int32, device=self.device)
        if op == "Mean":
            return ts[0].mean(dim=tuple(_ints(ins[1])), keepdim=_flag(node, "keep_dims"))
        raise AssertionError(op)  # every op of SUPPORTED_OPS is handled above
