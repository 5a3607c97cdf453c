"""Port parity: data parallelism across processes
(color_transfer_tpu_torch/parallel/multihost.py, data_parallel.py) against
color_transfer_tpu/parallel — start-up's no-op and guard, the rows each
process loads, and real two-process ``gloo`` train steps.

Two worker processes (torch only) each take their 4 rows of an 8-row
global batch and two DMSCT and four DCMCS3DI train steps (one of them in
the bf16 recipe); the same steps
run here at world 1 on the whole batch, and JAX's steps on its 8-device CPU
mesh on shared weights. DMSCT's matcher output is fed (random init makes
the matcher chaotic; test_torch_port_train.py). The "drawn" steps draw the
target distortions (and DMSCT's drop-connect) from the step's seed: world
2 must draw the global batch's and keep its rows. The "fixed" steps take
given targets with drop-connect off, as JAX's side must.

Lines (test_torch_port_train_step.py's): the logs 1e-5 relative; the
BatchNorm running statistics 1e-5 of max(1, max|ref|); each parameter's
update within 2e-7 of max(1, max|p|) where its gradient is clear (at least
1e-2 of its tensor's largest and of the model's largest) and within 2 lr
everywhere. The two ranks end bit-equal.
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

import test_torch_port_train as tt
from color_transfer_tpu.parallel import create_mesh, replicated_sharding, shard_batch
from color_transfer_tpu.parallel import multihost as jmh
from color_transfer_tpu_torch.parallel import multihost as tmh
from color_transfer_tpu_torch.tools.convert import dcmcs3di_state_dict_from_jax
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_dcmcs3di import C, EXT, TRA, params  # noqa: F401  (a fixture)
from test_torch_port_train import jax_fed_dmsct, jax_variables  # noqa: F401  (fixtures)

REPO = Path(__file__).resolve().parents[1]
B = 8  # the global batch; 4 rows a rank
DC_H, DC_W = 16, 40
STEPS = 7
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- start-up and rows -------------------------------------------------------


@pytest.fixture
def no_launcher(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)


def test_initialize_is_a_noop_for_one_process(no_launcher):
    assert tmh.initialize_distributed() == (0, 1) == jmh.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert tmh.rank_world() == (0, 1)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_initialize_refuses_a_world_without_address(no_launcher, monkeypatch, how):
    if how == "environment":
        monkeypatch.setenv("WORLD_SIZE", "2")
        kwargs = {}
    else:
        kwargs = {"num_processes": 2, "process_id": 0}
    with pytest.raises(ValueError, match="no coordinator address"):
        tmh.initialize_distributed(**kwargs, device="cpu")
    assert not torch.distributed.is_initialized()


def test_local_device(no_launcher, monkeypatch):
    assert tmh.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmh.local_device()
    assert tmh.local_device("cpu") == torch.device("cpu")  # an explicit device wins


@pytest.mark.parametrize("case", [(8, 0, 2), (8, 1, 2), (12, 2, 3), (6, 0, 1), (16, 3, 4),
                                  (9, 0, 2), (10, 1, 4)])
def test_host_batch_slice_matches_jax(case):
    try:
        want = jmh.host_batch_slice(*case)
    except AssertionError:
        with pytest.raises(AssertionError, match="not divisible"):
            tmh.host_batch_slice(*case)
        return
    assert tmh.host_batch_slice(*case) == want


def test_global_batch_single_process():
    rows = {"x": np.arange(16, dtype=np.float32).reshape(8, 2)}
    out = tmh.global_batch_from_host_shards(rows)
    np.testing.assert_array_equal(out["x"].numpy(), rows["x"])


# -- the two-process train steps ----------------------------------------------

# Run here (world 1, rows 0-8) and in each worker (world 2, its 4 rows).
_STEPS = textwrap.dedent('''
    import torch

    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule


    def _step(module, variables, inputs, rows, seed=5, fixed=False):
        """One train step on the rows of the inputs' global batch ->
        {logs, variables after, gradients as applied}."""
        data = {k: inputs[k][rows] for k in ("gt", "reference")}
        if fixed:
            target = inputs["target"][rows]
            module.synthesize_targets = lambda b, gen: {**b, "target": target}
        state = module.init_state(0, data, num_train_steps=7)
        with torch.no_grad():
            for k, v in state.variables.items():
                v.copy_(variables[k])
        grads = {}
        apply_gradients = module.apply_gradients

        def record(st):
            grads.update({k: v.grad.clone() for k, v in st.variables.items()
                          if v.grad is not None})
            apply_gradients(st)

        module.apply_gradients = record
        state, logs = module.train_step(state, data, seed=seed)
        return {"logs": {k: float(v) for k, v in logs.items()},
                "variables": {k: v.detach().clone() for k, v in state.variables.items()},
                "grads": grads}


    def run_steps(inputs, rows):
        out = {}
        dm = inputs["dmsct"]
        for name, fixed in (("dmsct drawn", False), ("dmsct fixed", True)):
            module = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1,
                                 heavy_metrics=False)
            if fixed:
                module.model.encoder.drop_connect_rate = 0.0
            fed = {k: v[rows] for k, v in dm["fed"].items()}
            module.model.matcher.register_forward_hook(lambda m, a, o: fed)
            out[name] = _step(module, dm["variables"], dm, rows, fixed=fixed)
        dc = inputs["dcmcs3di"]
        for name, fused, fixed, dtype in (
                ("dcmcs3di drawn chunked", True, False, None),
                ("dcmcs3di drawn materialised", False, False, None),
                ("dcmcs3di fixed chunked", True, True, None),
                ("dcmcs3di bf16 drawn chunked", True, False, "bfloat16")):
            module = DCMCS3DIModule(**dc["kw"], heavy_metrics=False, fused_attention=fused,
                                    attention_chunk=4, compute_dtype=dtype)
            out[name] = _step(module, dc["variables"], dc, rows, fixed=fixed)
        return out


    def masked_means(rows):
        """DCMCS3DI's two masked means on rows whose mask counts differ (rows
        0-3 mostly valid, 4-7 mostly not): the materialised loss's
        ``masked_l1`` and the chunked matcher's photometric and cycle terms."""
        from color_transfer_tpu_torch.models import pasm
        from color_transfer_tpu_torch.ops.parallax_train import chunked_parallax_train

        g = torch.Generator().manual_seed(0)
        x, y = torch.rand(2, 8, 6, 10, 3, generator=g)
        mask = torch.rand(8, 6, 10, 1, generator=g) < torch.tensor(
            [0.9] * 4 + [0.2] * 4).reshape(8, 1, 1, 1)
        qkv = torch.randn(5, 8, 6, 10, 4, generator=g) * 3
        imgs = torch.rand(2, 8, 6, 10, 3, generator=g)
        out = {"masked_l1": pasm.masked_l1(x[rows], y[rows], mask[rows])}
        losses = chunked_parallax_train(*(t[rows] for t in qkv), *(t[rows] for t in imgs),
                                        0.25, chunk=3)[3]
        out.update({k: losses[k] for k in ("photometric", "cycle")})
        return {k: v.detach() for k, v in out.items()}
''')

_WORKER = _STEPS + textwrap.dedent('''

    import sys

    from color_transfer_tpu_torch.parallel import multihost

    torch.set_num_threads(2)
    rank = int(sys.argv[1])
    world = multihost.initialize_distributed(sys.argv[2], 2, rank, device="cpu",
                                             timeout=120)
    assert world == (rank, 2), world
    start, stop = multihost.host_batch_slice(8)
    inputs = torch.load(sys.argv[3])
    out = run_steps(inputs, slice(start, stop))
    glued = multihost.global_batch_from_host_shards(
        {"gt": inputs["dmsct"]["gt"][start:stop]})["gt"]
    out["global batch equal"] = torch.equal(glued, inputs["dmsct"]["gt"])
    from color_transfer_tpu_torch.parallel import data_parallel
    with data_parallel.step_shard(4):
        out["masked means"] = {k: float(v) for k, v in
                               data_parallel.average_logs(masked_means(slice(start, stop))).items()}
    torch.save(out, sys.argv[4] + f"/rank{rank}.pt")
    print(f"OK rank {rank}")
''')


def _dmsct_inputs(jax_variables):
    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 1, (B, tt.H, tt.W, 3)).astype(np.float32)
    reference = np.clip(np.roll(gt, 2, axis=2) * 0.85 + 0.08, 0, 1).astype(np.float32)
    target = np.clip(gt ** 1.3 * 0.9 + 0.04, 0, 1).astype(np.float32)
    flow = rng.normal(size=(B, tt.H, tt.W, 2)) * 2.5
    flow = np.where(rng.uniform(size=(B, tt.H, tt.W, 1)) < 0.1, np.sign(flow) * 60.0, flow)
    fed = {"flow": flow.astype(np.float32),
           "fwd_occ": (rng.uniform(size=(B, tt.H, tt.W, 1)) < 0.1).astype(np.float32)}
    arrays = {"gt": gt, "reference": reference, "target": target}
    return arrays, fed


def _dcmcs3di_inputs():
    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (B, DC_H, DC_W, 3)).astype(np.float32)
    reference = np.clip(np.roll(gt, 3, axis=2) * 0.9 + 0.05, 0, 1).astype(np.float32)
    target = np.clip(gt ** 1.2 * 0.9 + 0.04, 0, 1).astype(np.float32)
    return {"gt": gt, "reference": reference, "target": target}


@pytest.fixture(scope="module")
def inputs(jax_variables, params):
    dm, fed = _dmsct_inputs(jax_variables)
    dc = _dcmcs3di_inputs()

    def t(arrays):
        return {k: torch.from_numpy(v) for k, v in arrays.items()}

    return {
        "dmsct": {**t(dm), "fed": t(fed),
                  "variables": tt._state_dict(jax_variables["params"],
                                              jax_variables["batch_stats"])},
        "dcmcs3di": {**t(dc), "kw": dict(extraction_layers=EXT, transfer_layers=TRA,
                                          channels=C),
                     "variables": dcmcs3di_state_dict_from_jax(params)},
        "numpy": {"dmsct": (dm, fed), "dcmcs3di": dc},
    }


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    """Both ranks' results of the two-process gloo run."""
    tmp = tmp_path_factory.mktemp("dp")
    torch.save({k: v for k, v in inputs.items() if k != "numpy"}, tmp / "inputs.pt")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "2"
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), coord,
                               str(tmp / "inputs.pt"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank {r}" in out, f"rank {r}:\n{out[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def world1(inputs):
    ns = {}
    exec(_STEPS, ns)  # noqa: S102 — the workers' own step code
    return ns["run_steps"]({k: v for k, v in inputs.items() if k != "numpy"}, slice(0, B))


def _hold(got, want, variables_before, grads, lr, params_names):
    """The module docstring's lines: got/want -> {name: tensor}."""
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    checked = 0
    for name, w in want["variables"].items():
        g_ = got["variables"][name]
        w = torch.as_tensor(np.asarray(w))
        if name.endswith(("running_mean", "running_var")):
            scale = max(1.0, float(w.abs().max()))
            assert float((g_ - w).abs().max()) <= 1e-5 * scale, name
        elif name in params_names and name in grads:
            g = grads[name].abs()
            p0 = variables_before[name]
            err = (g_ - w).abs()
            clear = g >= max(1e-2 * float(g.max()), floor)
            line = 2e-7 * max(1.0, float(p0.abs().max()))
            assert float(torch.where(clear, err, 0.0).max()) <= line, name
            assert float(err.max()) <= 2 * lr + 1e-8, name
            checked += 1
    assert checked > 10
    assert set(got["logs"]) == set(want["logs"])
    for k, v in want["logs"].items():
        assert abs(got["logs"][k] - v) <= 1e-5 * abs(v), (k, got["logs"][k], v)


def _names(name):
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule

    if name.startswith("dmsct"):
        model = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1).model
        lr = 3e-4
    else:
        model = DCMCS3DIModule(extraction_layers=EXT, transfer_layers=TRA, channels=C).model
        lr = 1e-4
    return {n for n, _ in model.named_parameters()}, lr


CASES = ["dmsct drawn", "dmsct fixed", "dcmcs3di drawn chunked",
         "dcmcs3di drawn materialised", "dcmcs3di fixed chunked",
         "dcmcs3di bf16 drawn chunked"]


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_world1(world2, world1, inputs, name):
    model = name.split()[0]
    names, lr = _names(name)
    _hold(world2[0][name], world1[name], inputs[model]["variables"], world1[name]["grads"],
          lr, names)


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_bit_equal(world2, name):
    a, b = world2[0][name], world2[1][name]
    assert a["logs"] == b["logs"]
    assert all(torch.equal(v, b["variables"][k]) for k, v in a["variables"].items())


def test_drawn_steps_draw_for_the_global_batch(world1, inputs):
    """The drawn DMSCT step's targets and drop-connect come from the seed:
    without the global draw, world 2's rows would differ from world 1's and
    its loss with them; the fixed step shows the draw matters at all."""
    assert world1["dmsct drawn"]["logs"] != world1["dmsct fixed"]["logs"]


def test_masked_means_are_the_global_batch_s(world2):
    """A masked mean over the ranks' rows whose mask counts differ is the
    global batch's (rank_mean divides by the ranks' mean count)."""
    ns = {}
    exec(_STEPS, ns)  # noqa: S102
    want = ns["masked_means"](slice(0, B))
    for rank in world2:
        for k, v in want.items():
            assert abs(rank["masked means"][k] - float(v)) <= 1e-6 * abs(float(v)), k


def test_global_batch_from_host_shards_two_ranks(world2):
    assert world2[0]["global batch equal"] and world2[1]["global batch equal"]


def _jax_dmsct_mesh_step(jdm, variables, dm, fed, monkeypatch):
    from color_transfer_tpu.run.modules import BNTrainState
    from color_transfer_tpu.run.modules import DMSCTModule as JModule

    monkeypatch.setattr(tt, "FED", fed)
    jmod = JModule(**tt.KW, heavy_metrics=False)
    jmod.synthesize_targets = lambda b, key: {**b, "target": jnp.asarray(dm["target"])}
    state = BNTrainState.create(apply_fn=jmod.model.apply, params=variables["params"],
                                tx=jmod.make_optimizer(STEPS),
                                batch_stats=variables["batch_stats"])
    mesh = create_mesh()
    state = jax.device_put(state, replicated_sharding(mesh))
    batch = shard_batch({"gt": jnp.asarray(dm["gt"]),
                         "reference": jnp.asarray(dm["reference"])}, mesh)
    new, logs = jmod.train_step(state, batch, jax.random.PRNGKey(0))
    after = tt._state_dict(jax.tree_util.tree_map(np.asarray, new.params),
                           jax.tree_util.tree_map(np.asarray, new.batch_stats))
    return {"variables": after, "logs": {k: float(v) for k, v in logs.items()}}


def _jax_dcmcs3di_mesh_step(params, dc):
    import optax
    from flax.training import train_state

    from color_transfer_tpu.run.modules import DCMCS3DIModule as JModule

    jmod = JModule(extraction_layers=EXT, transfer_layers=TRA, channels=C,
                   heavy_metrics=False, fused_attention=True, attention_chunk=4)
    jmod.synthesize_targets = lambda b, key: {**b, "target": jnp.asarray(dc["target"])}
    state = train_state.TrainState.create(apply_fn=jmod.model.apply, params=params,
                                          tx=optax.adam(jmod.learning_rate))
    mesh = create_mesh()
    state = jax.device_put(state, replicated_sharding(mesh))
    batch = shard_batch({"gt": jnp.asarray(dc["gt"]),
                         "reference": jnp.asarray(dc["reference"])}, mesh)
    new, logs = jmod.train_step(state, batch, jax.random.PRNGKey(0))
    return {"variables": dcmcs3di_state_dict_from_jax(new.params),
            "logs": {k: float(v) for k, v in logs.items()}}


def test_steps_match_jax_on_the_mesh(world2, world1, inputs, jax_variables, params,
                                     jax_fed_dmsct, monkeypatch):
    """The fixed steps at world 1 and world 2 against JAX's step on the
    8-device mesh, on shared weights."""
    assert len(jax.devices()) == 8
    dm, fed = inputs["numpy"]["dmsct"]
    want = {"dmsct fixed": _jax_dmsct_mesh_step(jax_fed_dmsct, jax_variables, dm, fed,
                                                monkeypatch),
            "dcmcs3di fixed chunked": _jax_dcmcs3di_mesh_step(params,
                                                              inputs["numpy"]["dcmcs3di"])}
    for name, w in want.items():
        model = name.split()[0]
        names, lr = _names(name)
        for got in (world1[name], world2[0][name]):
            _hold(got, w, inputs[model]["variables"], world1[name]["grads"], lr, names)
