"""The port's data parallelism (`idccrn_vae_torch/parallel/`) against its
own single-process step and the JAX package's 2-device mesh, on the CPU.

The helpers are held against JAX's: `shard_file_list`,
`local_batch_size`, `auto_world` (JAX's `auto_mesh` rule) and
`shard_batch` (JAX's `P('data')` rows, and its ValueError on a batch the
world does not divide).

Then one SGD step of each of the four trainers, from the JAX trainers'
initial weights, at a global batch of 4: pretraining with the MI term
(mi_weight 0.2, num_samples 2, real skips), the NSVAE with its partial
freeze (trainable noisy and clean encoders, frozen noise encoder),
adversarial phase 2 at d_step 2 (its first step updates D), and the
supervised DCCRN. The same step runs three ways:

  * the port in this process, without a group (world 1); its latent
    draws come from a seeded generator and are recorded;
  * the port on 2 Gloo ranks spawned together (`parallel.distributed.
    spawn`, every collective and the whole run bounded at 60 s), each
    rank drawing the global batch's noise from the same seed and keeping
    its rows (`parallel.mesh.randn_rows`);
  * the JAX trainer on a 2-device mesh, handed the recorded draws.

Tolerances:
  * world 2 against world 1. A rank's metrics are means over its own
    rows; their mean over the ranks is held to the world-1 metrics at
    1e-6 relative, and each parameter after the step at atol 1e-5
    (`WORLD1_BOUNDS`). The BN running statistics are held at atol 1e-6
    and rtol 1e-5. The counters must be equal, and the two ranks' states
    equal bit for bit. Pretraining, the NSVAE and the supervised step
    read at most 4.4e-7 (losses) and 6.9e-7 (parameters) here. Phase 2
    alone gets looser bounds
    (`PHASE2_WORLD1_BOUNDS`: losses 1e-5 relative, parameters atol 1e-5
    plus rtol 1e-3 of the update). The split batch sums its BN
    statistics, means and gradients in another order, and a sum that
    cancels loses relative precision: a PReLU slope's or a BN gamma's
    gradient is such a sum, and so is the SI-SNR gradient of a random
    decoder's near-orthogonal estimate. Phase 2's adversarial step at
    lr 1e-2 moves parameters by up to 2.1; its updates read 1.1e-5
    absolute here, a PReLU slope 7e-4 relative and the losses 1.5e-6
    relative on other batches. The test prints the margins
    (`pytest -rP`).
  * world 2 against the JAX mesh: the standing f32 rules of the port's
    trainer tests. Metrics at F32_TOL (atol/rtol 1e-4). Parameter
    updates at GRAD_TOL (atol 5e-6, rtol 5e-3). BN statistics at
    F32_TOL, counters exactly.
"""

import datetime

import jax
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from idccrn_vae_tpu.parallel.mesh import auto_mesh, make_mesh, pad_and_shard
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.parallel.mesh import auto_world, shard_batch
from torch_port_util import (
    check_step_against_jax,
    jax_step,
    port_step,
    step_cases,
)

GLOBAL_B = 4
TIMEOUT = datetime.timedelta(seconds=60)
# world 2 against world 1: (losses' relative bound, parameters' atol,
# parameters' rtol of the update), see the docstring
WORLD1_BOUNDS = (1e-6, 1e-5, 0.0)
PHASE2_WORLD1_BOUNDS = (1e-5, 1e-5, 1e-3)


def test_shard_file_list_matches_jax():
    from idccrn_vae_tpu.parallel.distributed import (
        shard_file_list as jax_shard,
    )

    for n_files in range(8):
        files = [f"f{i}.wav" for i in range(n_files)]
        for count in (1, 2, 3, 4):
            for index in range(count):
                assert distributed.shard_file_list(files, index, count) \
                    == jax_shard(files, index, count)


def test_local_batch_size_matches_jax(monkeypatch):
    from idccrn_vae_tpu.parallel import distributed as jax_dist

    for count in (1, 2, 3, 4):
        monkeypatch.setattr(jax, "process_count", lambda: count)
        monkeypatch.setattr(distributed, "world", lambda: count)
        for batch in range(1, 13):
            if batch % count:
                for fn in (jax_dist.local_batch_size,
                           distributed.local_batch_size):
                    with pytest.raises(ValueError, match="not divisible"):
                        fn(batch)
            else:
                assert distributed.local_batch_size(batch) == \
                    jax_dist.local_batch_size(batch) == batch // count


def test_auto_world_follows_auto_mesh(monkeypatch):
    """On CUDA the available count is the cards' (8 here, as JAX's 8
    virtual CPU devices), the default all of them; on the CPU each rank
    is a process, so the request itself is available (default 1)."""
    assert len(jax.devices()) == 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for batch in (1, 2, 3, 4, 6, 8, 12, 16, 24):
        for n in (None, 1, 2, 3, 4, 5, 8, 16):
            want = int(auto_mesh(batch, n).devices.size)
            assert auto_world(batch, n, "cuda") == want, (batch, n)
            if n is not None and n <= 8:
                assert auto_world(batch, n, "cpu") == want, (batch, n)
        assert auto_world(batch, None, "cpu") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert auto_world(16, 2, "cuda") == 1  # a one-card host


def test_shard_batch_rows_and_refusal(monkeypatch):
    """Rank r holds rows [r*B/n, (r+1)*B/n) of every array of the batch,
    as P('data') places them; a batch the world does not divide raises
    ValueError on both sides (JAX's from its P('data') device_put)."""
    batch = (np.arange(8.0).reshape(4, 2), np.arange(4.0))
    monkeypatch.setattr(distributed, "world", lambda: 2)
    for r in (0, 1):
        monkeypatch.setattr(distributed, "rank", lambda: r)
        got = shard_batch(batch)
        np.testing.assert_array_equal(got[0], batch[0][2 * r : 2 * r + 2])
        np.testing.assert_array_equal(got[1], batch[1][2 * r : 2 * r + 2])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(np.zeros((3, 16), np.float32))
    with pytest.raises(ValueError, match="divisible by 2"):
        pad_and_shard(make_mesh(2), np.zeros((3, 16), np.float32))


def test_two_ranks_match_one_process_and_the_jax_mesh(monkeypatch):
    cases = step_cases(monkeypatch, GLOBAL_B)
    recipes = [c[0] for c in cases]
    one = [port_step(monkeypatch, r) for r in recipes]
    assert [len(d) for *_, d in one] == [1, 4, 1, 0]
    # world 2: a thread per rank, all four steps in one group
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    two = distributed.spawn(ranks.steps_on_ranks, 2, args=(recipes,),
                            device="cpu", timeout=TIMEOUT,
                            deadline=TIMEOUT.total_seconds())
    assert len(two) == 2
    mesh = make_mesh(2)
    for k, (recipe, jtr, state, paths) in enumerate(cases):
        kind = recipe["kind"]
        (m1, s1, draws), (m2a, s2), (m2b, s2b) = one[k], two[0][k], two[1][k]
        # the ranks hold the same state
        for name in s2:
            assert s2[name][1] == s2b[name][1]
            for key, v in s2[name][0].items():
                assert torch.equal(v, s2b[name][0][key]), (kind, name, key)
        # world 2 against world 1
        loss_rel, atol, rtol = (PHASE2_WORLD1_BOUNDS if kind == "phase2"
                                else WORLD1_BOUNDS)
        mean = {key: (m2a[key] + m2b[key]) / 2 for key in m1}
        worst = max(abs(mean[key] - m1[key]) / abs(m1[key]) for key in m1)
        assert worst <= loss_rel, (kind, mean, m1)
        upd = buf = scale = 0.0
        trainer = ranks.build(recipe)
        for name, (sd0, _counts) in recipe["models"].items():
            assert s2[name][1] == s1[name][1], (kind, name)
            params = {n for n, _ in trainer.models[name].named_parameters()}
            for key, v0 in sd0.items():
                a, b = s1[name][0][key], s2[name][0][key]
                if key in params:
                    np.testing.assert_allclose(
                        (b - v0).numpy(), (a - v0).numpy(), atol=atol,
                        rtol=rtol, err_msg=f"{kind} {name} {key}")
                    upd = max(upd, float((b - a).abs().max()))
                    scale = max(scale, float((a - v0).abs().max()))
                else:
                    np.testing.assert_allclose(
                        b.numpy(), a.numpy(), atol=1e-6, rtol=1e-5,
                        err_msg=f"{kind} {name} {key}")
                    buf = max(buf, float((b - a).abs().max()))
        print(f"{kind}: loss rel {worst:.3e}, update diff {upd:.3e} "
              f"(largest update {scale:.3e}), buffers {buf:.3e}")
        # world 2 against the JAX trainer on a 2-device mesh
        j1, want = jax_step(monkeypatch, jtr, state, recipe, draws, mesh)
        check_step_against_jax(recipe, mean, s2, want, j1, paths)
