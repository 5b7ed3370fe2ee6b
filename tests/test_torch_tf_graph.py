"""The port's frozen-graph stack (vaw_torch/evals: graphdef.py, tf_graph.py,
inception.py) against TensorFlow's protobuf code and the JAX package's
GraphDef compiler (vaw_tpu/evals/tf_graph.py).

- graphdef: its field numbers are those of TF's graph_pb2 descriptors; its
  parse of a graph equals TF's node for node (names, ops, inputs, every
  attr, every constant's value), on the composite graph of
  tests/test_tf_graph.py and on tests/_inception_graph.py's full
  InceptionV3 topology; TF parses its writer's bytes back to the same
  nodes, and chip_smoke.py's writer-built InceptionV3 graph is the TF-built
  one, node for node and weight for weight.
- tf_graph: each op against the JAX compiler (and TF's session) at the
  tolerance tests/test_tf_graph.py uses (atol 2e-4, rtol 1e-4): conv SAME
  and VALID at stride 1 and 2 on odd sizes (asymmetric SAME padding), both
  pools at SAME edges, the legacy resize with both align_corners, the
  global batch norm, the old-style Concat, matmul and softmax; then the
  composite graph, and the full topology at batch 1 against the JAX
  compiler called eagerly (atol 1e-3, rtol 1e-3, as its synthetic-graph
  tests). SUPPORTED_OPS is the JAX set; an op outside it raises naming
  itself.
- inception: the backend factory refuses the JAX package's backends and
  unknown names, and never falls back.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow").compat.v1
tf.disable_eager_execution()

from tensorflow.core.framework import (  # noqa: E402
    attr_value_pb2,
    graph_pb2,
    node_def_pb2,
    tensor_pb2,
    tensor_shape_pb2,
    versions_pb2,
)

from vaw_torch.evals import graphdef  # noqa: E402
from vaw_torch.evals import inception as port_inception  # noqa: E402
from vaw_torch.evals import tf_graph as port_tf_graph  # noqa: E402
from vaw_tpu.evals import tf_graph as jax_tf_graph  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from _inception_graph import build_inception_v3_pb  # noqa: E402
from test_tf_graph import _bngn_graph_def, _build_inception_composite_pb  # noqa: E402

ATOL, RTOL = 2e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def full_pb(tmp_path_factory):
    return build_inception_v3_pb(str(tmp_path_factory.mktemp("inc") / "inception.pb"),
                                 seed=0)


# ------------------------------------------------------------- the codec


def test_field_numbers_are_graph_pb2s():
    messages = {
        "GraphDef": graph_pb2.GraphDef, "VersionDef": versions_pb2.VersionDef,
        "NodeDef": node_def_pb2.NodeDef, "AttrValue": attr_value_pb2.AttrValue,
        "AttrValue.ListValue": attr_value_pb2.AttrValue.ListValue,
        "TensorProto": tensor_pb2.TensorProto,
        "TensorShapeProto": tensor_shape_pb2.TensorShapeProto,
        "TensorShapeProto.Dim": tensor_shape_pb2.TensorShapeProto.Dim,
    }
    entry = node_def_pb2.NodeDef.DESCRIPTOR.fields_by_name["attr"].message_type
    assert set(graphdef.FIELDS) == set(messages) | {"NodeDef.AttrEntry"}
    for name, fields in graphdef.FIELDS.items():
        desc = entry if name == "NodeDef.AttrEntry" else messages[name].DESCRIPTOR
        for field, number in fields.items():
            assert desc.fields_by_name[field].number == number, (name, field)


def _tf_attr(a):
    """A TF AttrValue as (kind, comparable value)."""
    kind = a.WhichOneof("value")
    if kind == "list":
        lv = a.list
        return kind, (list(lv.s), list(lv.i), [float(np.float32(f)) for f in lv.f],
                      list(lv.b), list(lv.type), [[d.size for d in s.dim] for s in lv.shape])
    if kind == "shape":
        return kind, [d.size for d in a.shape.dim]
    if kind == "tensor":
        return kind, tf.make_ndarray(a.tensor)
    if kind == "f":
        return kind, float(np.float32(a.f))
    return kind, getattr(a, kind)


def _port_attr(a: graphdef.AttrValue, kind: str):
    """The port's AttrValue read as the kind TF reports."""
    if kind == "list":
        lv = a.list
        return kind, (lv.s, lv.i, [float(np.float32(f)) for f in lv.f], lv.b, lv.type,
                      [s.dims for s in lv.shape])
    if kind == "shape":
        return kind, a.shape.dims
    if kind == "tensor":
        return kind, a.tensor.numpy()
    if kind == "f":
        return kind, float(np.float32(a.f))
    return kind, getattr(a, kind)


def _assert_same_nodes(port_gd: graphdef.GraphDef, tf_gd):
    assert [n.name for n in port_gd.node] == [n.name for n in tf_gd.node]
    for p, t in zip(port_gd.node, tf_gd.node):
        assert (p.op, p.input, p.device) == (t.op, list(t.input), t.device), p.name
        assert set(p.attr) == set(t.attr), p.name
        for key, value in t.attr.items():
            kind, want = _tf_attr(value)
            _, got = _port_attr(p.attr[key], kind)
            if kind == "tensor":
                assert got.dtype == want.dtype and got.shape == want.shape, (p.name, key)
                np.testing.assert_array_equal(got, want)
            else:
                assert got == want, (p.name, key, got, want)


def _tf_parse(data: bytes):
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(data)
    return gd


@pytest.mark.parametrize("which", ["composite", "full"])
def test_reader_parses_as_tf_and_tf_reads_the_writer(which, full_pb, tmp_path):
    pb = full_pb if which == "full" else _build_inception_composite_pb(tmp_path)
    data = Path(pb).read_bytes()
    ours, theirs = graphdef.parse_graph_def(data), _tf_parse(data)
    assert ours.producer == theirs.versions.producer == 8
    _assert_same_nodes(ours, theirs)
    again = _tf_parse(graphdef.serialize_graph_def(ours))
    assert again.versions.producer == 8
    _assert_same_nodes(ours, again)
    _assert_same_nodes(graphdef.load_graph_def(pb), again)


def test_chip_smoke_writer_builds_the_tf_graph(full_pb):
    """chip_smoke.py's InceptionV3 graph, written with the port's writer,
    is tests/_inception_graph.py's TF-built graph (seed 0), node for node."""
    import chip_smoke

    built = chip_smoke.inception_graph_def(seed=0)
    theirs = {n.name: n for n in _tf_parse(Path(full_pb).read_bytes()).node}
    mine = _tf_parse(graphdef.serialize_graph_def(built))
    assert {n.name for n in mine.node} == set(theirs)
    tf_ordered = graph_pb2.GraphDef()
    tf_ordered.node.extend(theirs[n.name] for n in mine.node)
    _assert_same_nodes(built, tf_ordered)


def test_splat_and_value_lists():
    t = graphdef.TensorProto(dtype=1, tensor_shape=graphdef.TensorShape([2, 3]),
                             float_val=[1.5])
    np.testing.assert_array_equal(t.numpy(), np.full((2, 3), 1.5, np.float32))
    t = graphdef.TensorProto(dtype=3, tensor_shape=graphdef.TensorShape([4]),
                             int_val=[7, -2])
    np.testing.assert_array_equal(t.numpy(), np.array([7, -2, -2, -2], np.int32))
    # what TF writes for splats and scalars parses to TF's values
    for value, shape in ((np.float32(0.25), [3, 2]), (np.int32(-5), [2]),
                         (np.float32(2.0), None), (np.array([True, False]), None)):
        proto = tf.make_tensor_proto(value, shape=shape)
        ours = graphdef._tensor(memoryview(proto.SerializeToString()))
        np.testing.assert_array_equal(ours.numpy(), tf.make_ndarray(proto))


# -------------------------------------------------------------- the ops


def _run_three(build, feeds, fetches, arrays):
    """Build with TF, run TF's session, the JAX compiler and the port's on
    the same arrays; returns (tf, jax, port) outputs."""
    graph = tf.Graph()
    with graph.as_default():
        build()
    with tf.Session(graph=graph) as sess:
        tf_out = sess.run(fetches, dict(zip(feeds, arrays)))
    gd = graph.as_graph_def()
    jax_out = jax_tf_graph.GraphDefFunction(gd, feeds, fetches)(*arrays)
    port_gd = graphdef.parse_graph_def(gd.SerializeToString())
    with torch.no_grad():
        port_out = port_tf_graph.GraphDefFunction(port_gd, feeds, fetches)(*arrays)
    wrap = (lambda o: list(o) if isinstance(o, (list, tuple)) else [o])  # noqa: E731
    return wrap(tf_out), wrap(jax_out), wrap(port_out)


def _assert_three(outs, atol=ATOL, rtol=RTOL):
    tf_out, jax_out, port_out = outs
    for t, j, p in zip(tf_out, jax_out, port_out):
        p = p.numpy()
        np.testing.assert_allclose(p, np.asarray(j), atol=atol, rtol=rtol)
        np.testing.assert_allclose(p, t, atol=atol, rtol=rtol)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [(3, 3), (1, 7)])
def test_conv2d(padding, stride, kernel):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 15, 13, 3).astype(np.float32)
    w = rs.randn(*kernel, 3, 8).astype(np.float32) * 0.2

    def build():
        inp = tf.placeholder(tf.float32, x.shape, name="inp")
        tf.nn.conv2d(inp, tf.constant(w), [1, stride, stride, 1], padding, name="y")

    _assert_three(_run_three(build, ["inp:0"], ["y:0"], [x]))


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (2, 2)])
def test_pools_at_same_edges(op, k, s):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 15, 13, 4).astype(np.float32)

    def build():
        inp = tf.placeholder(tf.float32, x.shape, name="inp")
        pool = tf.nn.max_pool if op == "max" else tf.nn.avg_pool
        pool(inp, [1, k, k, 1], [1, s, s, 1], "SAME", name="y")
        pool(inp, [1, k, k, 1], [1, s, s, 1], "VALID", name="v")

    _assert_three(_run_three(build, ["inp:0"], ["y:0", "v:0"], [x]))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(7, 5), (16, 16), (29, 9)])
def test_resize_bilinear_legacy(align_corners, out_hw):
    x = np.random.RandomState(2).randn(2, 11, 13, 3).astype(np.float32)

    def build():
        inp = tf.placeholder(tf.float32, x.shape, name="inp")
        tf.image.resize_bilinear(inp, out_hw, align_corners=align_corners, name="y")

    _assert_three(_run_three(build, ["inp:0"], ["y:0"], [x]))


@pytest.mark.parametrize("scale_after", [True, False])
def test_global_batch_norm(scale_after):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    m, beta, gamma = (rs.randn(4).astype(np.float32) for _ in range(3))
    v = rs.rand(4).astype(np.float32) + 0.5
    gd = _bngn_graph_def(m, v, beta, gamma, 0.001, scale_after)
    graph = tf.Graph()
    with graph.as_default():
        inp = tf.placeholder(tf.float32, x.shape)
        (out,) = tf.import_graph_def(gd, input_map={"inp:0": inp}, return_elements=["bn:0"],
                                     name="g")
    with tf.Session(graph=graph) as sess:
        want = sess.run(out, {inp: x})
    jax_out = jax_tf_graph.GraphDefFunction(gd, ["inp:0"], ["bn:0"])(x)
    port_gd = graphdef.parse_graph_def(gd.SerializeToString())
    got = port_tf_graph.GraphDefFunction(port_gd, ["inp:0"], ["bn:0"])(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_old_style_concat_and_concat_v2():
    rs = np.random.RandomState(4)
    a = rs.randn(1, 4, 4, 2).astype(np.float32)
    b = rs.randn(1, 4, 4, 3).astype(np.float32)

    def build():
        pa = tf.placeholder(tf.float32, a.shape, name="a")
        pb = tf.placeholder(tf.float32, b.shape, name="b")
        tf.raw_ops.Concat(concat_dim=tf.constant(3), values=[pa, pb], name="cat")
        tf.concat([pb, pa], -1, name="cat2")

    _assert_three(_run_three(build, ["a:0", "b:0"], ["cat:0", "cat2:0"], [a, b]))


@pytest.mark.parametrize("transpose_b", [False, True])
def test_matmul_softmax_reshape(transpose_b):
    rs = np.random.RandomState(5)
    x = rs.randn(3, 1, 1, 16).astype(np.float32)
    w = rs.randn(16, 10).astype(np.float32)
    w = w.T.copy() if transpose_b else w

    def build():
        inp = tf.placeholder(tf.float32, x.shape, name="inp")
        flat = tf.reshape(inp, [3, 16], name="flat")
        logits = tf.matmul(flat, tf.constant(w), transpose_b=transpose_b, name="mm")
        tf.nn.softmax(tf.nn.bias_add(logits, tf.constant(np.arange(10, dtype=np.float32))),
                      name="sm")

    _assert_three(_run_three(build, ["inp:0"], ["mm:0", "sm:0"], [x]))


def test_composite_graph(tmp_path):
    pb = _build_inception_composite_pb(tmp_path)
    img = np.random.RandomState(12).rand(10, 10, 3).astype(np.float32) * 255.0
    fetches = ["pool_3:0", "mixed_6/relu:0", "softmax:0"]
    gd = _tf_parse(Path(pb).read_bytes())
    with tf.Session(graph=tf.Graph()) as sess:
        tf.import_graph_def(gd, name="")
        tf_out = sess.run(fetches, {"img:0": img})
    jax_out = jax_tf_graph.GraphDefFunction(gd, ["img:0"], fetches)(img)
    port_out = port_tf_graph.GraphDefFunction(graphdef.load_graph_def(pb), ["img:0"],
                                              fetches)(img)
    _assert_three((tf_out, jax_out, port_out))


def test_full_topology_batch_one_against_the_jax_compiler(full_pb):
    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32) * 255
    fetches = ["pool_3:0", "mixed_6/conv:0", "softmax:0"]
    jfn = jax_tf_graph.GraphDefFunction(jax_tf_graph.load_graph_def(full_pb),
                                        ["ExpandDims:0"], fetches)
    want = [np.asarray(o) for o in jfn(x)]
    got = port_tf_graph.GraphDefFunction(graphdef.load_graph_def(full_pb), ["ExpandDims:0"],
                                         fetches)(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3, rtol=1e-3)
    # the backend's features and softmax head: pool_3 and mixed_6/conv[..., :7]
    # flattened in NHWC order, softmax over pool @ W with no bias
    backend = port_inception.InceptionV3GraphFeatures(full_pb, device="cpu")
    pool, spatial = backend.features(x)
    assert pool.shape == (1, 2048) and spatial.shape == (1, 17 * 17 * 7)
    np.testing.assert_allclose(pool, want[0].reshape(1, -1), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(spatial, want[1][..., :7].reshape(1, -1), atol=1e-3,
                               rtol=1e-3)
    w = jfn.const("softmax/weights")
    logits = want[0].reshape(1, -1) @ w
    probs = np.exp(logits - logits.max()) / np.exp(logits - logits.max()).sum()
    np.testing.assert_allclose(backend.softmax_probs(pool), probs, atol=1e-4, rtol=1e-3)


def test_supported_ops_are_the_jax_set():
    assert port_tf_graph.SUPPORTED_OPS == jax_tf_graph.SUPPORTED_OPS


def test_an_unsupported_op_raises_naming_it():
    def build():
        inp = tf.placeholder(tf.float32, [2, 3], name="inp")
        tf.math.tanh(inp, name="y")

    graph = tf.Graph()
    with graph.as_default():
        build()
    gd = graphdef.parse_graph_def(graph.as_graph_def().SerializeToString())
    fn = port_tf_graph.GraphDefFunction(gd, ["inp:0"], ["y:0"])
    with pytest.raises(NotImplementedError, match="'Tanh'"):
        fn(np.zeros((2, 3), np.float32))


# ------------------------------------------------------------ the backend


def test_backend_factory_refuses_and_never_falls_back(tmp_path, monkeypatch):
    pb = _build_inception_composite_pb(tmp_path)
    monkeypatch.delenv("VAW_INCEPTION_BACKEND", raising=False)
    for name in ("tf", "jax"):
        with pytest.raises(ValueError, match="belongs to the JAX package"):
            port_inception.make_inception_backend(name, pb_path=pb, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        port_inception.make_inception_backend("onnx", pb_path=pb, device="cpu")
    for name in ("auto", "torch"):
        backend = port_inception.make_inception_backend(name, pb_path=pb, device="cpu")
        assert isinstance(backend, port_inception.InceptionV3GraphFeatures)
    monkeypatch.setenv("VAW_INCEPTION_BACKEND", "tf")
    with pytest.raises(ValueError, match="belongs to the JAX package"):
        port_inception.make_inception_backend("auto", pb_path=pb, device="cpu")
    monkeypatch.delenv("VAW_INCEPTION_BACKEND")
    monkeypatch.delenv("VAW_INCEPTION_PB", raising=False)
    monkeypatch.chdir(tmp_path)
    if port_inception.find_inception_pb() is None:
        with pytest.raises(FileNotFoundError, match="VAW_INCEPTION_PB"):
            port_inception.make_inception_backend("auto", device="cpu")
    monkeypatch.setenv("VAW_INCEPTION_PB", pb)
    assert port_inception.find_inception_pb() == pb
