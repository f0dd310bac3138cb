"""The LSTM recurrence kernel (`csrc/lstm_recurrence.cu`, launched by
`ops/lstm.py` `_layer_cuda`) against the eager step loop
(`_layer_plain`), and the rules by which `_layer` picks between them.

On the CPU (about a second): a CPU tensor takes the loop and leaves
`COUNTERS` alone; with the card's tensors stood in for (`is_cuda` read
as true, the kernel replaced by a recorder), no grad takes the kernel,
and recording autograd or tracing takes the loop.

On the card (`card`, skipped without one): the kernel and the loop on
the same inputs, bf16 and float32; S = 1 and 2; H = 1, 128, 384 and 768;
N = 2, 16 and 256; T = 1, 10, 501 and 1701; with and without a carried
(h, c). `out` and the final h and c are held in relative L2:
  * bf16: BF16_REL_L2. Both sides take the same bf16 operands with exact
    products and float32 sums; only the order of the sums differs, and
    where that moves a float32 gate across a rounding boundary of h one
    element of h changes by a bf16 ulp (2**-8 relative), which later
    steps carry on.
  * float32: F32_REL_L2: the sums' order alone.
Readings on an H100 80GB HBM3 over the 240 cases: bf16 at most 4.55e-4
(H 768, T 501 and 1701), float32 at most 1.82e-7. Planted in a copy of
the source and built on the card, over the same 240 cases: c rounded to
bf16 between steps reads 1.19e-3 to 5.96e-3 (both dtypes), the
recurrent term taken from h_{t-2} 0.058 to 0.175 (T > 1: one step has
no h_{t-2}), the recurrent term dropped 0.046 to 0.39; each fails the
test. So 7e-4 sits 1.5x above the bf16 kernel's largest and 1.7x below
the smallest fault, and 1e-5 55x above the float32 kernel's.
Inputs that the kernel does not take raise: a non-contiguous or bf16 xp,
a float16 compute dtype.

The file imports nothing of JAX, so it runs on the card without
`tests/conftest.py` (which does): `python -m pytest --noconftest
tests/test_torch_port_lstm_kernel.py -m card`.
"""

import itertools
import os
from unittest import mock

import pytest
import torch

from idccrn_vae_torch.ops import lstm

# the cores per xdist worker, as tests/torch_port_util.py caps them
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

BF16_REL_L2 = 7e-4
F32_REL_L2 = 1e-5


def inputs(s, t_len, n, hid, cdt, carry, device, seed=0):
    """xp ~ N(0, 1) (projection and biases), w_hh ~ U(+-1/sqrt(H)) as
    torch's LSTM draws it, both held in float32 at compute-dtype values;
    the carry's h at compute-dtype values, its c ~ N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    xp = torch.randn(s, t_len, n, 4 * hid, device=device, generator=g)
    bound = hid ** -0.5
    w_hh = ((torch.rand(s, 4 * hid, hid, device=device, generator=g) * 2 - 1)
            * bound).to(cdt).float()
    state = None
    if carry:
        state = (torch.randn(s, n, hid, device=device, generator=g).tanh()
                 .to(cdt), torch.randn(s, n, hid, device=device, generator=g))
    return xp, w_hh, state


def rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def test_dispatch_rules_on_the_cpu():
    """CPU -> loop, COUNTERS untouched; a card tensor (stood in for) with
    no grad -> the kernel; recording or tracing -> the loop."""
    xp, w_hh, state = inputs(2, 5, 3, 4, torch.bfloat16, True, "cpu")
    before = dict(lstm.COUNTERS)
    want = lstm._layer_plain(xp, w_hh, torch.bfloat16, state)
    got = lstm._layer(xp, w_hh, torch.bfloat16, state)
    assert lstm.COUNTERS == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][1], want[1][1])

    calls = []

    def kernel(*args):
        calls.append(args)
        return "kernel"

    with mock.patch.object(torch.Tensor, "is_cuda", True), \
            mock.patch.object(lstm, "_layer_cuda", kernel):
        with torch.no_grad():
            assert lstm._layer(xp.requires_grad_(), w_hh, torch.bfloat16,
                               state) == "kernel"
        assert len(calls) == 1 and lstm.COUNTERS == before
        out, (_, c) = lstm._layer(xp, w_hh, torch.bfloat16, state)
        (out.float().sum() + c.sum()).backward()
        assert xp.grad is not None and len(calls) == 1
        assert lstm.COUNTERS["loop_steps"] == before["loop_steps"] + 5
        with torch.no_grad(), mock.patch.object(lstm, "_traced",
                                                lambda: True):
            lstm._layer(xp, w_hh, torch.bfloat16, state)
        assert len(calls) == 1
        assert lstm.COUNTERS["loop_steps"] == before["loop_steps"] + 10
    lstm.COUNTERS.update(before)


CASES = [dict(cdt=cdt, s=s, hid=hid, n=n, t_len=t_len, carry=carry)
         for cdt, s, hid, n, (t_len, carry) in itertools.product(
             (torch.bfloat16, torch.float32), (1, 2), (1, 128, 384, 768),
             (2, 16, 256),
             ((1, True), (10, True), (10, False), (501, False), (1701, True)))]
FAULTS = [dict(cdt=torch.bfloat16, s=2, hid=384, n=16, t_len=10, carry=False,
               fault=fault)
          for fault in ("xp_strided", "xp_bf16", "cdt_half")]


def _id(case):
    name = "{}-s{}-h{}-n{}-t{}-{}".format(
        "bf16" if case["cdt"] == torch.bfloat16 else "f32", case["s"],
        case["hid"], case["n"], case["t_len"],
        "carry" if case["carry"] else "zeros")
    return f"{name}-{case['fault']}" if "fault" in case else name


@pytest.mark.card
@pytest.mark.parametrize("case", CASES + FAULTS, ids=_id)
def test_kernel_against_the_loop_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cdt = case["cdt"]
    xp, w_hh, state = inputs(case["s"], case["t_len"], case["n"],
                             case["hid"], cdt, case["carry"], "cuda")
    fault = case.get("fault")
    if fault:
        if fault == "xp_strided":
            xp = xp.transpose(1, 2).contiguous().transpose(1, 2)
        elif fault == "xp_bf16":
            xp = xp.to(torch.bfloat16)
        else:
            cdt = torch.float16
        with pytest.raises(ValueError):
            lstm._layer_cuda(xp, w_hh, cdt, state)
        return
    launches = lstm.COUNTERS["kernel_launches"]
    with torch.no_grad():
        out, (h, c) = lstm._layer(xp, w_hh, cdt, state)
        want, (want_h, want_c) = lstm._layer_plain(xp, w_hh, cdt, state)
    assert lstm.COUNTERS["kernel_launches"] - launches == 1
    assert out.dtype == cdt and c.dtype == torch.float32
    tol = BF16_REL_L2 if cdt == torch.bfloat16 else F32_REL_L2
    errs = [rel_l2(out, want), rel_l2(h, want_h), rel_l2(c, want_c)]
    assert max(errs) < tol, errs
