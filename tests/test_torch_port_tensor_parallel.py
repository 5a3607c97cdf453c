"""Port parity: tensor parallelism of the matcher transformer
(color_transfer_tpu_torch/parallel/tensor_parallel.py and the layers' route
in models/gmflow.py) against color_transfer_tpu/parallel/tensor_parallel.py,
at tests/test_tensor_parallel.py's shape: GMFlow with 2 transformer layers
and 1 refinement on (2, 32, 64) pairs, the port's seeded weights carried to
JAX by tools/convert_gmflow.py.

World 1 runs here; world 2 (the ``model`` axis over 2 ranks) runs as gloo
worker processes (torch only): each rank holds its slices of the q/k/v,
``mlp.0`` (output features), ``merge`` and ``mlp.2`` (input features)
weights. JAX runs its TP-sharded forward on its (2, 4) ('data', 'model')
mesh.

Lines: the flow within 5e-3 (JAX's own line, tests/test_tensor_parallel.py:
63: the C contraction summed over ranks reassociates, and the GRU loop
carries it); the transformer's output features within 1e-4 of max(1,
max|ref|) (f32, sums in another order); in bf16 (the matcher's compute
dtype; world 1 on the same unfused route) within 2 bf16 ulps of their
magnitude: the row-parallel products round once after the sum, where the
unsharded product rounds, and the sum's order may flip a rounding. The ranks
bit-equal.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from color_transfer_tpu.models.gmflow import GMFlow as JGMFlow
from color_transfer_tpu.parallel import create_mesh
from color_transfer_tpu.parallel.tensor_parallel import (
    matcher_tp_shardings,
    shard_matcher_params,
)
from color_transfer_tpu.tools.convert_gmflow import convert_state_dict
from color_transfer_tpu_torch.models import gmflow as tg
from color_transfer_tpu_torch.parallel import tensor_parallel as tp
from color_transfer_tpu_torch.parallel.mesh import Axis
from color_transfer_tpu_torch.run.modules import random_state_dict
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
LAYERS, REFINE = 2, 1
FLOW_LINE, FEATURE_RTOL, BF16_ULPS = 5e-3, 1e-4, 2

# Run here (world 1, no group) and in each worker (world 2).
_RUN = textwrap.dedent('''
    import contextlib

    import torch

    from color_transfer_tpu_torch.models import gmflow
    from color_transfer_tpu_torch.parallel import tensor_parallel as tp


    def run(inputs, axis):
        """The f32 GMFlow forward's flow and its transformer's outputs, and
        the bf16 transformer's, on this rank's slices."""
        model = gmflow.GMFlow(num_transformer_layers=2, num_reg_refine=1).eval()
        features = []
        model.transformer.register_forward_hook(lambda m, a, o: features.append(o))
        variables = inputs["variables"]
        bf16 = gmflow.FeatureTransformer(2, fused_attention=False, dtype=torch.bfloat16)
        bf16_vars = {k[len("transformer."):]: v for k, v in variables.items()
                     if k.startswith("transformer.")}
        if axis is not None:
            variables = tp.shard_matcher_state(variables, axis)
            bf16_vars = tp.shard_matcher_state(
                {"transformer." + k: v for k, v in bf16_vars.items()}, axis)
            bf16_vars = {k[len("transformer."):]: v for k, v in bf16_vars.items()}
        with torch.no_grad(), (tp.tensor_parallel(axis) if axis is not None
                               else contextlib.nullcontext()):
            out = torch.func.functional_call(model, variables, inputs["images"], strict=True)
            f0, f1 = inputs["features"]
            bf16_out = torch.func.functional_call(bf16, bf16_vars, (f0, f1, 2), strict=True)
        return {"flow": out["flow"], "flow_bwd": out["flow_bwd"], "features": features,
                "bf16": bf16_out}
''')

_WORKER = _RUN + textwrap.dedent('''

    import sys

    from color_transfer_tpu_torch.parallel import multihost
    from color_transfer_tpu_torch.parallel.mesh import process_mesh

    torch.set_num_threads(1)
    rank, coord = int(sys.argv[1]), sys.argv[2]
    multihost.initialize_distributed(coord, 2, rank, device="cpu", timeout=120)
    mesh = process_mesh((1, 2), ("data", "model"))
    out = run(torch.load(sys.argv[3]), mesh["model"])
    torch.save(out, sys.argv[4] + f"/rank{rank}.pt")
    # Every rank done before any leaves: rank 0 holds the store the others
    # talk to, and a rank that exits with its group alive aborts.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"OK rank {rank}")
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs():
    port = tg.GMFlow(num_transformer_layers=LAYERS, num_reg_refine=REFINE).eval()
    sd = random_state_dict(port, seed=5)
    rng = np.random.default_rng(0)
    img0 = rng.uniform(0, 255, (2, 32, 64, 3)).astype(np.float32)
    img1 = np.clip(np.roll(img0, 2, axis=2) + rng.uniform(-20, 20, img0.shape), 0,
                   255).astype(np.float32)
    features = [rng.normal(size=(1, 8, 16, 128)).astype(np.float32) for _ in range(2)]
    return {"variables": sd, "images": (torch.from_numpy(img0), torch.from_numpy(img1)),
            "features": [torch.from_numpy(f) for f in features],
            "numpy": (img0, img1)}


@pytest.fixture(scope="module")
def world1(inputs):
    ns = {}
    exec(_RUN, ns)  # noqa: S102 — the workers' own code
    return ns["run"](inputs, None)


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    torch.save({k: v for k, v in inputs.items() if k != "numpy"}, tmp / "inputs.pt")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), coord,
                               str(tmp / "inputs.pt"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"OK rank {r}" in log, f"rank {r}:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


def _close(got, want, rtol):
    want = np.asarray(want)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


def test_specs_cover_the_transformer_matmuls(inputs):
    """tests/test_tensor_parallel.py:36's counts (2 layers: 14 column, 6
    row), and the same weights as JAX's specs, name for name."""
    specs = tp.matcher_tp_specs(inputs["variables"])
    counts = {s: sum(v == s for v in specs.values()) for s in ("column", "row", "replicated")}
    assert counts["column"] == 2 * (3 + 3 + 1) and counts["row"] == 2 * (1 + 1 + 1)
    assert counts["replicated"] > 0
    params = convert_state_dict({k: v.numpy() for k, v in inputs["variables"].items()},
                                num_layers=LAYERS)
    mesh = create_mesh(shape=(2, 4), axis_names=("data", "model"))
    shardings = jax.tree_util.tree_flatten_with_path(matcher_tp_shardings(params, mesh))[0]
    jax_specs = {}
    for path, sh in shardings:
        keys = [getattr(p, "key", None) for p in path]
        if sh.spec != P():
            jax_specs[(keys[-4], keys[-3], keys[-2])] = ("column" if sh.spec == P(None, "model")
                                                         else "row")
    port_specs = {}
    for name, spec in specs.items():
        if spec != "replicated":
            parts = name.split(".")
            layer = parts[parts.index("layers") + 1]
            sub = parts[parts.index("layers") + 2]
            proj = tp._layer_name(name).replace(".", "_")
            port_specs[(f"layer_{layer}", sub, proj)] = spec
    assert port_specs == jax_specs


def test_shards_split_the_right_axis(inputs):
    sd = inputs["variables"]
    name_col = "transformer.layers.0.cross_attn_ffn.mlp.0.weight"
    name_row = "transformer.layers.0.cross_attn_ffn.mlp.2.weight"
    shards = [tp.shard_matcher_state(sd, Axis(None, i, 4)) for i in range(4)]
    assert torch.equal(torch.cat([s[name_col] for s in shards], dim=0), sd[name_col])
    assert torch.equal(torch.cat([s[name_row] for s in shards], dim=1), sd[name_row])
    key = "backbone.conv1.weight"
    assert all(s[key] is sd[key] for s in shards)
    with pytest.raises(ValueError, match="128 features do not split over 3 ranks"):
        tp.shard_matcher_state(sd, Axis(None, 0, 3))


def test_fused_attention_under_tp(inputs):
    """``fused_attention=True`` raises under tensor parallelism; "auto"
    takes the unfused route (in bf16, where "auto" would fuse)."""
    fused = tg.FeatureTransformer(1, fused_attention=True)
    f = torch.zeros(1, 8, 16, 128)
    with tp.tensor_parallel(Axis(None, 0, 1)):
        with pytest.raises(ValueError, match="fused_attention=True under tensor parallelism"):
            fused(f, f, 2)
        auto = tg.FeatureTransformer(1, dtype=torch.bfloat16)
        unfused = tg.FeatureTransformer(1, fused_attention=False, dtype=torch.bfloat16)
        unfused.load_state_dict(auto.state_dict())
        x = torch.randn(1, 8, 16, 128, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            assert all(torch.equal(a, b) for a, b in zip(auto(x, x, 2), unfused(x, x, 2)))


def test_world2_matches_world1(world2, world1):
    for rank in world2:
        for key in ("flow", "flow_bwd"):
            np.testing.assert_allclose(rank[key].numpy(), world1[key].numpy(),
                                       rtol=FLOW_LINE, atol=FLOW_LINE)
        assert len(rank["features"]) == len(world1["features"]) == 2  # the two scales
        for got, want in zip(rank["features"], world1["features"]):
            for g, w in zip(got, want):
                _close(g, w.numpy(), FEATURE_RTOL)


def test_world2_bf16_keeps_its_rounding_points(world2, world1):
    for rank in world2:
        for got, want in zip(rank["bf16"], world1["bf16"]):
            assert got.dtype == want.dtype == torch.bfloat16
            want = want.float().numpy()
            ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
            assert float(np.abs(got.float().numpy() - want).max()) <= BF16_ULPS * ulp


def test_ranks_bit_equal(world2):
    a, b = world2
    assert torch.equal(a["flow"], b["flow"]) and torch.equal(a["flow_bwd"], b["flow_bwd"])
    assert all(torch.equal(x, y) for x, y in zip(a["bf16"], b["bf16"]))


def test_matches_jax_tp_forward(inputs, world2, world1):
    """The port's world 1 and world 2 flows against JAX's TP-sharded forward
    on its (2, 4) mesh (JAX's own test holds that to its replicated one)."""
    params = convert_state_dict({k: v.numpy() for k, v in inputs["variables"].items()},
                                num_layers=LAYERS)
    model = JGMFlow(num_transformer_layers=LAYERS, num_reg_refine=REFINE)
    img0, img1 = (jnp.asarray(x) for x in inputs["numpy"])
    mesh = create_mesh(shape=(2, 4), axis_names=("data", "model"))
    data = NamedSharding(mesh, P("data"))
    sharded = jax.jit(lambda p, a, b: model.apply({"params": p}, a, b)["flow"])(
        shard_matcher_params(params, mesh), jax.device_put(img0, data),
        jax.device_put(img1, data))
    for got in (world1["flow"], world2[0]["flow"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(sharded), rtol=FLOW_LINE,
                                   atol=FLOW_LINE)
