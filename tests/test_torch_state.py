"""The port's optimizers (training/state.py) against the JAX package's, on
the CPU.

- ``amsgrad: true``: the port's ``OptaxAmsgrad`` against ``optax.amsgrad``
  (what confignet_tpu/training/state.py takes) on the same seeded float32
  parameters and a seeded sequence of 6 gradients whose scale rises and
  falls, so the running maximum of the second moment outlasts the moment
  itself: parameters held to rtol 1e-6 after every step, the optimizer's
  moments, running maximum and step count (a tensor) too.
- The default: the port's ``OptaxAdam`` against ``optax.adam`` alike.
- One stage-1 step of TINY_FIRST_STAGE_CONFIG with ``amsgrad: true`` through
  both packages, at tests/test_torch_train.py's tolerances, and the running
  maximum among the tensors a mesh replicates.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import TINY_FIRST_STAGE_CONFIG
from test_torch_train import _player_trees, check_ema, check_gradients, check_losses, step_both
from confignet_tpu_torch.core.model_io import export_jax_tensors
from confignet_tpu_torch.training import first_stage
from confignet_tpu_torch.training.first_stage import PLAYER_TREES
from confignet_tpu_torch.training.state import OptaxAdam, OptaxAmsgrad, make_adam

torch.set_num_threads(1)

SHAPES = [(5, 3), (7,), (2, 3, 4)]
GRADIENT_SCALES = [1.0, 3.0, 0.1, 0.01, 2.0, 0.5]  # the maximum must outlast its moment


def amsgrad_case(seed):
    rng = np.random.default_rng(seed)
    # |p| >= 0.5: six steps of at most lr * sqrt(1 / (1 - b2)) keep them off zero
    params = [(rng.uniform(0.5, 2.0, size=s) * rng.choice([-1, 1], size=s)).astype(np.float32)
              for s in SHAPES]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]
             for scale in GRADIENT_SCALES]
    return params, grads


def hold_to_optax(tx, optimizer, params, grads, tparams, fields):
    """Step ``optimizer`` and optax's ``tx`` through the same gradients from
    the same parameters: after every step the parameters, the step count
    (a float32 tensor on the parameters' device) and each state tensor in
    ``fields`` ({torch key: optax field}) within rtol 1e-6."""
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    for step, grad in enumerate(grads, 1):
        updates, jstate = tx.update([jnp.asarray(g) for g in grad], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grad):
            p.grad = torch.from_numpy(g)
        optimizer.step()
        for i, (got, want) in enumerate(zip(tparams, jparams)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       err_msg=f"step {step}, parameter {i}")
            state = optimizer.state[got]
            count = state["step"]
            assert torch.is_tensor(count) and count.dtype == torch.float32
            assert count.device == got.device and count.shape == ()
            assert state["step"] == step == int(jstate[0].count)
            for key, field in fields.items():
                np.testing.assert_allclose(state[key].numpy(), np.asarray(getattr(jstate[0], field)[i]),
                                           rtol=1e-6, err_msg=f"step {step}, {key} {i}")


@pytest.mark.parametrize("b1", [0.0, 0.5])
@pytest.mark.parametrize("lr", [1e-2, 4e-4])
def test_amsgrad_matches_optax(lr, b1):
    """optax.amsgrad(lr, b1, b2=0.9, eps=1e-7) against make_adam's
    ``amsgrad`` optimizer, step by step (b1 0.0 is the players' config)."""
    params, grads = amsgrad_case(int(lr * 1e4) + int(b1 * 10))
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    optimizer = make_adam(tparams, {"lr": lr, "beta_1": b1, "beta_2": 0.9, "amsgrad": True})
    assert isinstance(optimizer, OptaxAmsgrad)
    hold_to_optax(optax.amsgrad(lr, b1=b1, b2=0.9, eps=1e-7), optimizer, params, grads, tparams,
                  {"exp_avg": "mu", "exp_avg_sq": "nu", "max_exp_avg_sq": "nu_max"})
    # the maximum outlasted the moment (GRADIENT_SCALES falls after step 2)
    state = optimizer.state[tparams[0]]
    assert (state["max_exp_avg_sq"] > state["exp_avg_sq"] / (1 - 0.9 ** len(grads))).any()


@pytest.mark.parametrize("b1", [0.0, 0.5])
@pytest.mark.parametrize("lr", [1e-2, 4e-4])
def test_adam_matches_optax(lr, b1):
    """optax.adam(lr, b1, b2=0.9, eps=1e-7) against make_adam's default
    optimizer over the same six gradients: the players' optimizer, whose
    step count lives in a tensor so that a captured train step replays
    every later step's bias corrections."""
    params, grads = amsgrad_case(int(lr * 1e4) + int(b1 * 10) + 1)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    optimizer = make_adam(tparams, {"lr": lr, "beta_1": b1, "beta_2": 0.9})
    assert isinstance(optimizer, OptaxAdam) and not isinstance(optimizer, OptaxAmsgrad)
    hold_to_optax(optax.adam(lr, b1=b1, b2=0.9, eps=1e-7), optimizer, params, grads, tparams,
                  {"exp_avg": "mu", "exp_avg_sq": "nu"})
    assert "max_exp_avg_sq" not in optimizer.state[tparams[0]]


def test_amsgrad_skips_parameters_without_gradient():
    used, unused = (torch.nn.Parameter(torch.ones(3)) for _ in range(2))
    optimizer = OptaxAmsgrad([used, unused], lr=0.1, betas=(0.0, 0.9))
    used.grad = torch.full((3,), 2.0)
    optimizer.step()
    assert unused not in optimizer.state and torch.equal(unused.detach(), torch.ones(3))
    # step 1: mu_hat = g, nu_max = g^2, so the step is lr * g / (|g| + eps)
    np.testing.assert_allclose(used.detach().numpy(), 1.0 - 0.1 * 2.0 / (2.0 + 1e-7), rtol=1e-7)


@pytest.fixture(scope="module")
def amsgrad_stepped():
    return step_both(dict(TINY_FIRST_STAGE_CONFIG,
                          optimizer={"lr": 0.0004, "beta_1": 0.0, "beta_2": 0.9, "amsgrad": True}))


def test_amsgrad_stage1_step_matches_jax(amsgrad_stepped):
    """One stage-1 step with ``amsgrad: true`` in both packages: losses,
    every player's gradient (its first moment, b1 = 0) and the EMA
    generator at tests/test_torch_train.py's tolerances; each player's
    running maximum (after one step, its squared gradient) within the
    gradients' relative L2 bound doubled (squares double relative errors)."""
    jax_result, port_result = amsgrad_stepped
    check_losses(jax_result, port_result)
    for player in PLAYER_TREES:
        check_gradients(jax_result["moments"][player], port_result["moments"][player], player)
    check_ema(jax_result, port_result)
    model = port_result["model"]
    want = _player_trees(jax_result["state"], "nu_max")
    for player, trees in PLAYER_TREES.items():
        optimizer = model.optimizers[player]
        assert isinstance(optimizer, OptaxAmsgrad)
        state = optimizer.state
        got = {tree: export_jax_tensors((name, state[p]["max_exp_avg_sq"])
                                        for name, p in getattr(model, tree).named_parameters())
               for tree in trees}
        keys = [(tree, key) for tree in sorted(want[player]) for key in sorted(want[player][tree])]
        assert sorted(keys) == sorted((tree, key) for tree in got for key in got[tree])
        want_all = np.concatenate([want[player][t][k].ravel() for t, k in keys])
        got_all = np.concatenate([got[t][k].ravel() for t, k in keys])
        assert np.linalg.norm(got_all - want_all) < 2e-3 * np.linalg.norm(want_all), player


def test_amsgrad_state_is_replicated_over_a_mesh(amsgrad_stepped, monkeypatch):
    """``_use_mesh`` hands every optimizer tensor to ``replicate``: both
    moments and the running maximum of every parameter that has stepped."""
    model = amsgrad_stepped[1]["model"]
    handed = []
    monkeypatch.setattr(first_stage, "replicate", lambda mesh, tensors: handed.append(tensors))
    mesh = type("Mesh", (), {"size": 1, "device": torch.device("cpu")})()
    model._use_mesh(mesh)
    model.mesh = None
    replicated = {id(t) for t in handed[-1]}
    states = [state for optimizer in model.optimizers.values()
              for state in optimizer.state.values()]
    assert states and all(id(state[key]) in replicated for state in states
                          for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"))
