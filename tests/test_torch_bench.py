"""The port's bench entry points (confignet_tpu_torch/apps/bench.py and
bench_train.py) on the CPU at tiny widths, against the JAX package's
bench.py and bench_train.py at the repository root: the same configuration,
row names and metric names; the headline's loop body against JAX's on the
same inputs and weights; every row run once; failures that fail."""
import ast
import functools
import hashlib
import importlib.util
import itertools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from helpers import TINY_FIRST_STAGE_CONFIG
from confignet_tpu.core.init_cache import cached_init
from confignet_tpu.models.generator import HologanGenerator as JaxGenerator
from confignet_tpu_torch.apps import bench, bench_train
from confignet_tpu_torch.core.model_io import load_jax_params
from confignet_tpu_torch.models.blocks import ConvAdaIN
from confignet_tpu_torch.ops import launches

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_BENCH_TRAIN = REPO / "bench_train.py"
# the bench config at tiny widths and 128px; batch 24 and the 12 face-model
# inputs stay, so the rows keep the JAX metric names
TINY = dict(bench_train.BENCH_CONFIG,
            **{k: v for k, v in TINY_FIRST_STAGE_CONFIG.items()
               if k not in ("facemodel_inputs", "batch_size")})
# the generator's widths in the trainer's config keys, narrowed
NARROW_GENERATOR = {"n_generator_features": 16, "const_input_shape": (4, 4, 4, 8),
                    "n_adain_mlp_units": 8}
# per --only name: the JAX function and the metric names it emits at batch 24
JAX_ROWS = {
    "stage1_f32": ("bench_stage1", {"stage1_train_step_float32"}),
    "stage1_bf16": ("bench_stage1", {"stage1_train_step_bfloat16"}),
    "stage2_f32": ("bench_stage2", {"stage2_train_step_float32"}),
    "stage2_bf16": ("bench_stage2", {"stage2_train_step_bfloat16"}),
    "fine_tune": ("bench_fine_tune", {"one_shot_fine_tune"}),
    "serving": ("bench_serving", {"serving_encode_splice_generate"}),
    "gen512": ("bench_generator_512", {"generator_fwd_512_throughput"}),
    "checkpointing": ("bench_checkpointing", {
        "train_loop_ckpt_steady", "train_loop_ckpt_async", "train_loop_ckpt_sync",
        "ckpt_stall_per_event_async", "ckpt_overhead_at_500_async",
        "ckpt_stall_per_event_sync", "ckpt_overhead_at_500_sync"}),
}
# the port's rows at 1-2 iterations and small batches
TINY_ROWS = {
    "stage1_f32": lambda r: bench_train.bench_stage1(r, "float32", 1, TINY, "cpu"),
    "stage1_bf16": lambda r: bench_train.bench_stage1(r, "bfloat16", 1, TINY, "cpu"),
    "stage2_f32": lambda r: bench_train.bench_stage2(r, "float32", 1, TINY, "cpu"),
    "stage2_bf16": lambda r: bench_train.bench_stage2(r, "bfloat16", 1, TINY, "cpu"),
    "fine_tune": lambda r: bench_train.bench_fine_tune(r, 2, TINY, "cpu"),
    "serving": lambda r: bench_train.bench_serving(r, 2, TINY, "cpu", batch=2),
    "gen512": lambda r: bench_train.bench_generator_512(r, 2, TINY, "cpu", batch=1),
    "checkpointing": lambda r: bench_train.bench_checkpointing(r, 1, 1, TINY, "cpu",
                                                               metric_samples=4),
}
# rows that may be zero: a stall or overhead measured as none
NONNEGATIVE_UNITS = {"s", "%"}


def jax_bench_train():
    """The root bench_train.py as a module (it imports json, os and time at
    the top, JAX only inside its functions)."""
    spec = importlib.util.spec_from_file_location("jax_bench_train", JAX_BENCH_TRAIN)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plain(value):
    """Tuples as lists, as JSON has them."""
    return json.loads(json.dumps(value))


def jax_functions():
    tree = ast.parse(JAX_BENCH_TRAIN.read_text())
    return {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}


def jax_emitted_names(function: ast.FunctionDef) -> set:
    """Every name the function's ``_emit`` calls can give, each f-string
    evaluated over the values its fields take in bench_train.py."""
    values = {"dtype_name": ("float32", "bfloat16"), "suffix": ("",),
              "label": ("steady", "async", "sync")}
    names = set()
    for node in ast.walk(function):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_emit":
            expr = ast.Expression(node.args[1])
            fields = sorted({n.id for n in ast.walk(node.args[1]) if isinstance(n, ast.Name)})
            code = compile(expr, "bench_train.py", "eval")
            for combo in itertools.product(*(values[f] for f in fields)):
                names.add(eval(code, {}, dict(zip(fields, combo))))
    return names


def test_bench_config_matches_jax():
    assert plain(bench_train.BENCH_CONFIG) == plain(jax_bench_train().BENCH_CONFIG)


def test_row_names_match_jax():
    """The --only names, in the JAX script's order, and the metric names
    each JAX row emits (its f-strings evaluated) hold the port's names."""
    main = jax_functions()["main"]
    loops = [n for n in ast.walk(main) if isinstance(n, ast.For) and isinstance(n.iter, ast.List)]
    jax_only = [elt.elts[0].value for elt in loops[0].iter.elts]
    assert jax_only == list(bench_train.ROW_NAMES) == list(JAX_ROWS)
    functions = jax_functions()
    for name, (function, metrics) in JAX_ROWS.items():
        assert metrics <= jax_emitted_names(functions[function]), name


@pytest.mark.parametrize("batch_size, staged, r1_heads", [
    (24, False, "all"), (96, False, "all"), (24, True, "all"), (24, False, "final"),
    (192, True, "final")])
def test_metric_name_suffixes_match_jax(batch_size, staged, r1_heads):
    cfg = dict(bench_train.BENCH_CONFIG, batch_size=batch_size, r1_heads=r1_heads)
    assert (bench_train._metric_name_parts(cfg, staged)
            == jax_bench_train()._metric_name_parts(cfg, staged))


def test_headline_loop_matches_jax():
    """acc after 3 iterations of G(z + i*1e-6, rot), as bench.py's many()
    body computes it, on the same inputs (numpy seed 0, drawn as bench.py
    draws them) and weights (JAX's init, perturbed, carried by
    load_jax_params), f32 at a tiny width: acc within rtol 1e-4, the last
    image within atol 1e-4."""
    batch, n_iters = 2, 3
    z, rot = bench_train.generator_inputs(batch)
    rng = np.random.default_rng(0)  # bench.py:74-84
    want_z = rng.normal(size=(batch, 145)).astype(np.float32)
    want_rot = rng.uniform(-1.0, 1.0, size=(batch, 3)).astype(np.float32)
    want_rot *= np.array([np.pi / 6, np.pi / 18, 0.0], np.float32)
    np.testing.assert_array_equal(z, want_z)
    np.testing.assert_array_equal(rot, want_rot)

    widths = dict(n_adain_mlp_units=8, const_shape=(4, 4, 4, 8), n_features_first=16)
    jgen = JaxGenerator(latent_dim=145, output_shape=(256, 256), **widths)
    params = cached_init(jgen, jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(rot))["params"]
    rng = np.random.default_rng(15)
    flat = {"/".join(k): (np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                          * max(float(np.std(v)), 1.0)).astype(np.float32)
            for k, v in traverse_util.flatten_dict(params).items()}
    jparams = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                            for k, v in flat.items()})

    def many(p, z, r):  # bench.py:86-89
        def body(i, acc):
            out = jgen.apply({"params": p}, z + i * 1e-6, r)
            return acc + jnp.sum(out.astype(jnp.float32))
        return jax.lax.fori_loop(0, n_iters, body, 0.0)

    want_acc = float(jax.jit(many)(jparams, jnp.asarray(z), jnp.asarray(rot)))
    want_last = np.asarray(jgen.apply({"params": jparams}, jnp.asarray(z) + (n_iters - 1) * 1e-6,
                                      jnp.asarray(rot)))

    tgen = bench_train.bench_generator(256, torch.device("cpu"), NARROW_GENERATOR, dtype=None)
    load_jax_params(tgen, flat)
    with torch.no_grad():
        acc, last = bench_train.forward_loop(tgen, torch.from_numpy(z), torch.from_numpy(rot),
                                             n_iters)
    np.testing.assert_allclose(acc.item(), want_acc, rtol=1e-4)
    np.testing.assert_allclose(last.numpy(), want_last, atol=1e-4)


@pytest.mark.parametrize("config", [bench_train.BENCH_CONFIG, TINY], ids=["256px", "128px"])
def test_training_data_matches_the_root_bench(config):
    """The train rows' data: every array of the set the root bench_train.py
    draws (tests/helpers.FakeDataset at seed 0, the left eye copied from
    the rotations), equal."""
    want = jax_bench_train()._fake_dataset(config["output_shape"][0])
    got = bench_train.fake_dataset(config)
    np.testing.assert_array_equal(got.imgs, want.imgs)
    np.testing.assert_array_equal(got.eye_masks, want.eye_masks)
    np.testing.assert_array_equal(got.inception_features, want.inception_features)
    assert list(got.metadata_inputs) == list(want.metadata_inputs)
    for name, values in want.metadata_inputs.items():
        assert got.metadata_inputs[name].dtype == values.dtype, name
        assert np.array_equal(got.metadata_inputs[name], values), name
    rotations = got.metadata_inputs["rotations"]
    assert np.abs(rotations).max() <= 0.2 and np.abs(rotations[:, 2]).max() > 0.1
    np.testing.assert_array_equal(got.metadata_inputs["bone_rotations:left_eye"], rotations[:, :2])


def test_launch_table_matches_the_generator():
    """unit_launches' AdaIN sites are the generator's ConvAdaIN blocks, and
    the table is the one the bench asserts."""
    for size, sites in launches.ADAIN_SITES.items():
        generator = bench_train.bench_generator(size, torch.device("cpu"), NARROW_GENERATOR)
        assert sum(isinstance(m, ConvAdaIN) for m in generator.modules()) == sites
    assert launches.unit_launches("forward", 256) == (1, 0, 6, 0)
    assert launches.unit_launches("forward", 512) == (1, 0, 7, 0)
    assert launches.unit_launches("train_step", 256) == (4, 2, 24, 12)
    assert launches.unit_launches("train_step", 512) == (4, 2, 28, 14)
    assert launches.unit_launches("fine_tune_iteration", 256) == (0, 0, 6, 6)


def test_check_launches_refuses_other_counts():
    """On the card a window without its launches (the plain path) fails; on
    the CPU any launch fails."""
    launches.zero_launch_counts()
    with pytest.raises(AssertionError, match="expected"):
        bench_train.check_launches("row", (1, 0, 6, 0), torch.device("cuda"))
    assert bench_train.check_launches("row", (1, 0, 6, 0), torch.device("cpu")) == dict(
        rotate=0, transpose=0, adain=0, adain_backward=0)
    try:
        launches.KERNEL_WRAPPERS[2].launches = 6
        with pytest.raises(AssertionError, match="expected"):
            bench_train.check_launches("row", (1, 0, 6, 0), torch.device("cpu"))
    finally:
        launches.zero_launch_counts()


@pytest.mark.parametrize("name", list(TINY_ROWS))
def test_row_runs_on_cpu(name, tmp_path, monkeypatch):
    """Each row at tiny widths on the CPU: the JAX names, finite rates (a
    stall or an overhead may be zero), no kernel launch, the CPU named, and
    no file left in the working directory."""
    monkeypatch.chdir(tmp_path)
    results = []
    TINY_ROWS[name](results)
    assert {row["metric"] for row in results} == JAX_ROWS[name][1]
    for row in results:
        assert math.isfinite(row["value"]), row
        assert row["value"] >= 0 if row["unit"] in NONNEGATIVE_UNITS else row["value"] > 0, row
        assert set(row["launches"].values()) == {0}, row
        assert (row["device"], row["kind"], row["card"]) == ("cpu", None, None), row
    assert list(tmp_path.iterdir()) == []


def test_headline_main_prints_one_row(capsys, monkeypatch):
    """main's row, with the generator narrowed (the reference's widths take
    minutes on the CPU)."""
    monkeypatch.setattr(bench, "generator_throughput", functools.partial(
        bench_train.generator_throughput, config=NARROW_GENERATOR))
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "N_ITERS", 2)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == "generator_fwd_256_throughput" and row["unit"] == "img/s"
    assert row["value"] > 0 and (row["batch"], row["n_iters"]) == (2, 2)
    assert row["graph_img_s"] is None and row["card"] is None and "vs_baseline" not in row


def test_failed_row_fails_the_run(tmp_path, monkeypatch):
    """A row that raises gives an error row, the others still run, main
    returns 1; --out is the only file written and the JAX bench's
    BENCH_TRAIN.json keeps its bytes."""
    jax_results = REPO / "BENCH_TRAIN.json"
    before = hashlib.sha256(jax_results.read_bytes()).hexdigest()

    def broken(results):
        raise RuntimeError("row broke")

    monkeypatch.setattr(bench_train, "rows", lambda args, config, device: {
        "stage1_f32": broken, "gen512": TINY_ROWS["gen512"]})
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rows.json"
    assert bench_train.main(["--device", "cpu", "--out", str(out)]) == 1
    rows = json.loads(out.read_text())
    assert rows[0] == {"metric": "stage1_f32", "error": "RuntimeError: row broke"}
    assert rows[1]["metric"] == "generator_fwd_512_throughput"
    assert list(tmp_path.iterdir()) == [out]
    assert hashlib.sha256(jax_results.read_bytes()).hexdigest() == before
    with pytest.raises(SystemExit):
        bench_train.main(["--device", "cpu", "--only", "stage3", "--out", str(out)])


def test_no_card_and_no_device_exits_nonzero(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "rows.json"
    assert bench.main([]) != 0
    assert bench_train.main(["--out", str(out)]) != 0
    assert not out.exists()
    assert capsys.readouterr().out == ""
