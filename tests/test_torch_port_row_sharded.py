"""Port parity: the row-sharded DCMCS3DI evaluation
(color_transfer_tpu_torch/parallel/row_attention_sp.py) against
color_transfer_tpu/parallel/row_attention_sp.py, at tests/test_row_sharded.py's
shapes: the parallax attention at (1, 16, 32, 8), the whole model (2
extraction and 1 transfer ResB blocks, 8 channels) on (2, 32, 24) pairs.

World 1 runs here; world 2 (rows over 2 ranks) and world 4 (frames over 2
ranks x rows over 2) run as gloo worker processes (torch only), each rank
returning the whole output. JAX runs its own sharded functions on its
8-device CPU mesh on the same weights and inputs.

Lines: the sharded output within 2e-5 of the unsharded one and of JAX's
(JAX's own line, tests/test_row_sharded.py:63: the halo convs sum in
another order); the parallax warp within 1e-5 of the materialised
reference (JAX's line) and the valid masks exact; the ranks bit-equal.
Every 3x3 conv traded its halo: the bytes summed equal the model's count.
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

from color_transfer_tpu.models import dcmcs3di as jdc
from color_transfer_tpu.models import pasm as jpasm
from color_transfer_tpu.parallel import create_mesh
from color_transfer_tpu.parallel.row_attention_sp import (
    sharded_eval_forward as j_eval,
    sharded_parallax_inference as j_parallax,
)
from color_transfer_tpu.run.modules import DCMCS3DIModule as JModule
from color_transfer_tpu_torch.parallel import row_attention_sp as sp
from color_transfer_tpu_torch.parallel.mesh import Axis
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule
from color_transfer_tpu_torch.tools.convert import dcmcs3di_state_dict_from_jax
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
KW = dict(extraction_layers=2, transfer_layers=1, channels=8)
B, H, W = 2, 32, 24
EVAL_ATOL, WARP_ATOL = 2e-5, 1e-5
WORLDS = {2: (1, 2), 4: (2, 2)}  # world -> (data, seq)

_WORKER = textwrap.dedent('''
    import sys

    import torch

    from color_transfer_tpu_torch.parallel import multihost
    from color_transfer_tpu_torch.parallel import row_attention_sp as sp
    from color_transfer_tpu_torch.parallel.mesh import process_mesh
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule

    torch.set_num_threads(1)
    rank, world, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    shape = tuple(int(n) for n in sys.argv[6].split("x"))
    multihost.initialize_distributed(coord, world, rank, device="cpu", timeout=120)
    mesh = process_mesh(shape, ("data", "seq"))
    inputs = torch.load(sys.argv[4])
    module = DCMCS3DIModule(**inputs["kw"])
    out = {"eval": sp.sharded_eval_forward(module, inputs["variables"], inputs["batch"], mesh),
           "halo_bytes": sp.halo_bytes}
    if shape[0] == 1:
        out["parallax"] = sp.sharded_parallax_inference(*inputs["qkv"], inputs["scale"], mesh)
    try:
        sp.sharded_eval_forward(module, inputs["variables"], inputs["odd"], mesh)
    except ValueError as e:
        out["odd rows"] = str(e)
    torch.save(out, sys.argv[5] + f"/rank{rank}.pt")
    # Every rank done before any leaves: rank 0 holds the store the others
    # talk to, and a rank that exits with its group alive aborts.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"OK rank {rank}")
''')


def _free_ports(n):
    """``n`` distinct free ports: every socket stays bound until all are
    chosen."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _fill(path, shape, rng):
    """The JAX init's law, U(+-1/sqrt(fan_in)) (test_torch_port_dcmcs3di.py)."""
    fan_in = int(np.prod(shape[:-1])) if path[-1].key == "kernel" else 9 * KW["channels"]
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    model = jdc.DCMCS3DI(**KW)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(11)
    return jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s.shape, rng), shapes)


@pytest.fixture(scope="module")
def inputs(params):
    rng = np.random.default_rng(4)
    batch = {k: rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
             for k in ("target", "reference")}
    qkv = [rng.normal(size=(1, 16, 32, 8)).astype(np.float32) for _ in range(5)]
    odd = {k: rng.uniform(0, 1, (B, 33, W, 3)).astype(np.float32)
           for k in ("target", "reference")}
    return {"numpy": {"batch": batch, "qkv": qkv},
            "torch": {"kw": KW, "variables": dcmcs3di_state_dict_from_jax(params),
                      "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                      "odd": {k: torch.from_numpy(v) for k, v in odd.items()},
                      "qkv": [torch.from_numpy(q) for q in qkv], "scale": 1.0 / 8}}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Every rank's results of the world-2 and world-4 gloo runs, started
    together."""
    tmp = tmp_path_factory.mktemp("sp")
    torch.save(inputs["torch"], tmp / "inputs.pt")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = {}
    for (world, (data, seq)), port in zip(WORLDS.items(), _free_ports(len(WORLDS))):
        out = tmp / f"world{world}"
        out.mkdir()
        coord = f"127.0.0.1:{port}"
        procs[world] = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), coord, str(tmp / "inputs.pt"),
             str(out), f"{data}x{seq}"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = {}
    try:
        for world, ps in procs.items():
            logs[world] = [p.communicate(timeout=300)[0] for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for world, ps in procs.items():
        for r, (p, log) in enumerate(zip(ps, logs[world])):
            assert p.returncode == 0 and f"OK rank {r}" in log, f"world {world} rank {r}:\n{log}"
    return {world: [torch.load(tmp / f"world{world}" / f"rank{r}.pt") for r in range(world)]
            for world in WORLDS}


@pytest.fixture(scope="module")
def world1(inputs):
    """The port's unsharded evaluation and its world-1 sharded functions
    (no process group)."""
    module = DCMCS3DIModule(**KW)
    t = inputs["torch"]
    return {"eval_forward": module.eval_forward(t["variables"], t["batch"]),
            "sharded": sp.sharded_eval_forward(module, t["variables"], t["batch"]),
            "parallax": sp.sharded_parallax_inference(*t["qkv"], t["scale"])}


@pytest.fixture(scope="module")
def jax_out(params, inputs):
    """JAX's sharded evaluation on its (2, 4) ('data', 'seq') mesh and its
    row-sharded attention on 8 devices."""
    assert len(jax.devices()) == 8
    module = JModule(**KW, heavy_metrics=False)
    batch = {k: jnp.asarray(v) for k, v in inputs["numpy"]["batch"].items()}
    out = j_eval(module, params, batch, create_mesh(shape=(2, 4), axis_names=("data", "seq")))
    warped, mask = j_parallax(create_mesh(shape=(8,), axis_names=("seq",)),
                              *map(jnp.asarray, inputs["numpy"]["qkv"]), 1.0 / 8)
    return {"eval": np.asarray(out), "warped": np.asarray(warped), "mask": np.asarray(mask)}


def _halo_bytes(world):
    """Bytes the world's halo all-reduces sum on a rank: each 3x3 conv sums
    an (n_seq, 2, frames, 1, W, C_in) f32 buffer."""
    data, seq = WORLDS[world]
    b, c, ext, tra = B // data, KW["channels"], KW["extraction_layers"], KW["transfer_layers"]
    rows = [(2 * b, 3)] + [(2 * b, c)] * (2 * ext) + [(2 * b, c)] * 2  # extraction, head
    rows += [(b, c)] * (2 * tra) + [(b, c), (b, c // 2)]  # transfer: ResB, two tail convs
    return sum(seq * 2 * frames * W * cin * 4 for frames, cin in rows)


def test_parallax_world1_matches_jax_and_the_materialised_path(inputs, world1, jax_out):
    warped, mask = world1["parallax"]
    q_l, k_r, v_r, q_r, k_l = (jnp.asarray(x) for x in inputs["numpy"]["qkv"])
    att, _, masks = jpasm.output((jnp.einsum("bhwc,bhvc->bhwv", q_l, k_r) / 8,
                                  jnp.einsum("bhwc,bhvc->bhwv", q_r, k_l) / 8), inference=True)
    np.testing.assert_allclose(warped.numpy(), np.asarray(jpasm.warp(v_r, att[0])),
                               atol=WARP_ATOL)
    np.testing.assert_allclose(warped.numpy(), jax_out["warped"], atol=WARP_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(masks[0]))
    np.testing.assert_array_equal(mask.numpy(), jax_out["mask"])


def test_eval_world1_matches_jax(world1, jax_out):
    for got in (world1["eval_forward"], world1["sharded"]):
        np.testing.assert_allclose(got.numpy(), jax_out["eval"], atol=EVAL_ATOL)
    np.testing.assert_allclose(world1["sharded"].numpy(), world1["eval_forward"].numpy(),
                               atol=EVAL_ATOL)


@pytest.mark.parametrize("world", list(WORLDS))
def test_eval_sharded_matches_world1_and_jax(worlds, world1, jax_out, world):
    ranks = worlds[world]
    for rank in ranks:
        assert rank["eval"].shape == (B, H, W, 3)
        np.testing.assert_allclose(rank["eval"].numpy(), world1["eval_forward"].numpy(),
                                   atol=EVAL_ATOL)
        np.testing.assert_allclose(rank["eval"].numpy(), jax_out["eval"], atol=EVAL_ATOL)
        assert torch.equal(rank["eval"], ranks[0]["eval"])
        assert rank["halo_bytes"] == _halo_bytes(world)


def test_parallax_world2_matches_world1(worlds, world1):
    warped, mask = world1["parallax"]
    for rank in worlds[2]:
        got_warped, got_mask = rank["parallax"]
        np.testing.assert_allclose(got_warped.numpy(), warped.numpy(), atol=WARP_ATOL)
        assert torch.equal(got_mask, mask)
        assert torch.equal(got_warped, worlds[2][0]["parallax"][0])


@pytest.mark.parametrize("world", list(WORLDS))
def test_rows_that_do_not_divide_raise(worlds, world):
    seq = WORLDS[world][1]
    for rank in worlds[world]:
        assert rank["odd rows"] == f"33 image rows do not split over {seq} ranks"


def test_row_bounds_and_frames():
    assert sp.row_bounds(32, Axis(None, 1, 4)) == (8, 16)
    with pytest.raises(ValueError, match="30 image rows do not split over 4 ranks"):
        sp.row_bounds(30, Axis(None, 0, 4))
    with pytest.raises(ValueError, match="3 frames do not split over 2 ranks"):
        sp._frames(3, Axis(None, 0, 2))
