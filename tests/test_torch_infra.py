"""The port's training infrastructure on the CPU: the checkpoint worker, the
batch prefetcher, the kernels' launch counters under threads, the seed
chain, the profiler hook and the training CLIs' flags.  Every test that could hang on a thread runs its body under
``_within`` (a 30 s limit), so a deadlock fails instead of stalling the run.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from confignet_tpu.apps import train_attribute_classifier as jax_train_attribute_classifier
from confignet_tpu.apps import train_confignet as jax_train_confignet
from confignet_tpu.apps import train_latent_gan as jax_train_latent_gan
from confignet_tpu_torch.apps import train_attribute_classifier, train_confignet, train_latent_gan
from confignet_tpu_torch.core.async_checkpoint import CheckpointWorker
from confignet_tpu_torch.core.profiling import maybe_trace
from confignet_tpu_torch.core.randomness import KeyChain, initialize_random_seed, key_or_seed
from confignet_tpu_torch.data.prefetch import BatchPrefetcher

torch.set_num_threads(1)


def _within(fn, seconds=30.0):
    """fn() on a thread; fails if it has not returned after ``seconds``."""
    result = {}

    def run():
        try:
            result["value"] = fn()
        except BaseException as exc:  # re-raised below
            result["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(seconds)
    assert not thread.is_alive(), f"still running after {seconds} s"
    if "error" in result:
        raise result["error"]
    return result.get("value")


def test_checkpoint_worker_runs_jobs_in_order():
    def body():
        done = []
        worker = CheckpointWorker()
        for i in range(6):
            worker.submit(lambda i=i: (time.sleep(0.01), done.append(i)))
        worker.drain()
        assert done == list(range(6))
        worker.submit(lambda: done.append(6))
        worker.close()
        assert done == list(range(7))

    _within(body)


def test_checkpoint_worker_queue_is_bounded():
    def body():
        release = threading.Event()
        worker = CheckpointWorker(max_pending=2)
        worker.submit(release.wait)  # running
        worker.submit(lambda: None)
        worker.submit(lambda: None)  # the queue now holds 2
        blocked = threading.Thread(target=worker.submit, args=(lambda: None,), daemon=True)
        blocked.start()
        blocked.join(0.3)
        assert blocked.is_alive(), "submit did not block on a full queue"
        release.set()
        blocked.join(10)
        assert not blocked.is_alive()
        worker.close()

    _within(body)


def test_checkpoint_worker_reraises_the_first_error():
    def body():
        worker = CheckpointWorker()
        ran = []
        worker.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
        worker.submit(lambda: (_ for _ in ()).throw(ValueError("later")))
        worker.submit(lambda: ran.append(1))
        with pytest.raises(RuntimeError) as info:
            worker.drain()
        assert isinstance(info.value.__cause__, OSError)
        assert ran == [1]  # later jobs still run
        worker.submit(lambda: (_ for _ in ()).throw(KeyError("x")))
        with pytest.raises(RuntimeError) as info:
            worker.close()
        assert isinstance(info.value.__cause__, KeyError)

    _within(body)


def test_prefetcher_keeps_order_and_stages_on_the_device():
    def body():
        counter = iter(range(100))

        def sample():
            i = next(counter)
            return {"x": np.full((2, 3), i, np.uint8), "fm": (np.arange(3.0) + i, np.zeros(1))}

        with BatchPrefetcher(sample, depth=2, device="cpu") as prefetcher:
            batches = [prefetcher.next() for _ in range(10)]
        for i, batch in enumerate(batches):
            assert isinstance(batch["x"], torch.Tensor) and int(batch["x"][0, 0]) == i
            assert isinstance(batch["fm"], list) and float(batch["fm"][0][0]) == i
        raw = BatchPrefetcher(lambda: {"x": np.zeros(1)}, device_put=False)
        assert isinstance(raw.next()["x"], np.ndarray)
        raw.close()

    _within(body)


def test_prefetcher_raises_on_every_next_after_the_worker_dies():
    def body():
        def sample():
            raise ValueError("bad batch")

        prefetcher = BatchPrefetcher(sample, depth=4, device="cpu")
        for _ in range(3):
            with pytest.raises(ValueError, match="bad batch"):
                prefetcher.next()
        prefetcher.close()

    _within(body)


def test_prefetcher_close_with_a_full_queue_does_not_hang():
    def body():
        prefetcher = BatchPrefetcher(lambda: {"x": np.zeros(4)}, depth=1, device="cpu")
        deadline = time.time() + 10
        while not prefetcher._queue.full() and time.time() < deadline:
            time.sleep(0.01)
        assert prefetcher._queue.full()
        prefetcher.close()
        assert not prefetcher._thread.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            prefetcher.next()

    _within(body)


def test_launch_counts_are_exact_across_threads():
    """The kernel wrappers' launch counters are bumped from the training
    thread and the checkpoint worker at once: with a tiny switch interval
    and more threads than cores, no update is lost."""
    import sys

    from confignet_tpu_torch.ops import cuda_build

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 2000

    def bump():
        for _ in range(per_thread):
            cuda_build.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump, daemon=True) for _ in range(n_threads)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert wrapper.launches == n_threads * per_thread


def test_keychain_deterministic_and_resumable():
    a, b = KeyChain(seed=7), KeyChain(seed=7)
    assert a.next() == b.next()
    a.next()
    resumed = KeyChain(seed=7, position=a.position)
    assert resumed.position == a.position == 2
    assert resumed.next() == a.next()
    assert KeyChain(seed=8).next() != KeyChain(seed=7).next()
    x = KeyChain(seed=3).numpy_rng().normal(size=4)
    np.testing.assert_array_equal(x, KeyChain(seed=3).numpy_rng().normal(size=4))
    assert key_or_seed(5).initial_seed() == 5 and key_or_seed(None, 9).initial_seed() == 9
    initialize_random_seed(11)
    first = np.random.rand()
    initialize_random_seed(11)
    assert np.random.rand() == first


def test_maybe_trace_writes_a_trace(tmp_path):
    with maybe_trace(None):
        pass
    with maybe_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    written = os.listdir(tmp_path / "trace")
    assert len(written) == 1 and written[0].endswith(".json")
    assert "traceEvents" in json.loads((tmp_path / "trace" / written[0]).read_text())


@pytest.mark.parametrize("port_cli, jax_cli", [
    (train_confignet, jax_train_confignet),
    (train_latent_gan, jax_train_latent_gan),
    (train_attribute_classifier, jax_train_attribute_classifier),
], ids=["train_confignet", "train_latent_gan", "train_attribute_classifier"])
def test_cli_help_has_the_jax_flags(port_cli, jax_cli, capsys):
    """--help exits 0; the port's CLIs take every flag of JAX's, plus --device."""
    flags = []
    for cli in (port_cli, jax_cli):
        with pytest.raises(SystemExit) as info:
            cli.parse_args(["--help"])
        assert info.value.code == 0
        text = capsys.readouterr().out
        flags.append({word.strip("[],") for word in text.split() if word.startswith("--")})
    assert flags[0] == flags[1] | {"--device"}
