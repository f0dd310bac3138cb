"""cfg.remat in the port: each encoder and decoder stage recomputed in the
backward (`models/modules.py` `_stage_call`, torch.utils.checkpoint),
against the same step without remat and against the JAX package's
`jax.checkpoint` step.

One SGD step of each of the four trainers (`torch_port_util.step_cases`:
pretraining with the MI term, the NSVAE with its partial freeze,
adversarial phase 2 at d_step 2, the supervised DCCRN), from the JAX
trainers' initial weights. Every BN counter starts at 0, so the step is
the first one, whose batch statistics replace the running ones, and the
recompute runs while the forward has already moved the counter to 1.

Tolerances:
  * remat on against remat off, in the port: the recompute runs the
    same ops on the same inputs, so the losses, every parameter and
    every BN statistic are held at atol/rtol 1e-6, and the counters
    must be equal;
  * remat on against JAX's remat step: the standing f32 rules of the
    port's trainer tests (metrics at F32_TOL, parameter updates at
    GRAD_TOL, BN statistics at F32_TOL, counters exactly).
Every trained model's counters read 1 after the step (D's too: its
first step is a D-update batch), and frozen models' read 0.
"""

import dataclasses

import numpy as np

import torch_port_ranks as ranks
from torch_port_util import (
    check_step_against_jax,
    jax_step,
    port_step,
    step_cases,
)

TOL = dict(atol=1e-6, rtol=1e-6)
FROZEN = {("nsvae", "noise_enc"), ("phase2", "encoder")}


def without_remat(recipe):
    """The recipe with remat off in every config it carries."""
    args = tuple(dataclasses.replace(a, remat=False)
                 if dataclasses.is_dataclass(a) and hasattr(a, "remat")
                 else a for a in recipe["args"])
    return dict(recipe, args=args)


def test_remat_steps_match_plain_steps_and_jax(monkeypatch):
    cases = step_cases(monkeypatch, 3, remat=True)
    for recipe, jtr, state, paths in cases:
        kind = recipe["kind"]
        assert all(a.remat for a in recipe["args"] if hasattr(a, "remat"))
        assert all(set(c) == {0} for _, c in recipe["models"].values())
        m_on, s_on, draws = port_step(monkeypatch, recipe)
        m_off, s_off, draws_off = port_step(monkeypatch,
                                            without_remat(recipe))
        assert len(draws) == len(draws_off)
        for key in m_off:
            np.testing.assert_allclose(m_on[key], m_off[key],
                                       err_msg=f"{kind} {key}", **TOL)
        for name in recipe["models"]:
            assert s_on[name][1] == s_off[name][1], (kind, name)
            want = [0 if (kind, name) in FROZEN else 1] * len(s_on[name][1])
            assert s_on[name][1] == want, (kind, name, s_on[name][1])
            for key, v in s_off[name][0].items():
                np.testing.assert_allclose(
                    s_on[name][0][key].numpy(), v.numpy(),
                    err_msg=f"{kind} {name} {key}", **TOL)
        built = ranks.build(recipe)
        assert all(getattr(m, "cfg", None) is None or m.cfg.remat
                   for m in built.models.values())
        j1, want = jax_step(monkeypatch, jtr, state, recipe, draws)
        check_step_against_jax(recipe, m_on, s_on, want, j1, paths)
