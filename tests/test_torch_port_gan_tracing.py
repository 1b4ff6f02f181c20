"""The GAN steps' spans and counters (`flow2gan_tpu_torch/tracing.py`,
`training/gan_step.py`) on the CPU, at the small size of
`test_torch_port_gan_reference.py` with 4 Euler steps:

- with the switch on, one D step and one G step give one root span each,
  `gan.d_step` and `gan.g_step`, with everything else of the step nested
  inside: the rollout, the MPD's and the MRD's `gan.judge` (index 0 and 1)
  for each signal judged, the loss terms, backward and ScaledAdam; the
  counters count one step a side, and `solve.recomputed_steps` the Euler
  steps that `remat_rollout` recomputes in backward (4, or none);
- the steps' losses and parameters are bitwise the same with the switch
  off and on.
"""

import pytest
import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.models import RolloutDraws

from .test_torch_port_gan_reference import _batch, _draws, _port_steps, _weights

N = 4


@pytest.fixture(autouse=True)
def _fresh():
    """Each test starts and ends with the switch off, nothing kept, and
    two intra-op threads (the discriminators are full width)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(threads)


def _d_then_g(remat):
    gw, dw = _weights()
    gen, disc, _, _, d_step, g_step = _port_steps(gw, dw, remat, n_timesteps=N)
    batch = _batch()
    x0, gates = _draws(7, gen.num_limiters, N)
    losses = [float(d_step(batch, RolloutDraws(x0))["loss_d"]),
              float(g_step(batch, RolloutDraws(x0, gates))["loss_g"])]
    return losses, {**gen.state_dict(), **disc.state_dict()}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_one_root_span_a_step_and_the_counters(remat):
    tracing.enable()
    _d_then_g(remat)
    drained = tracing.drain()
    spans = drained.spans
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["gan.d_step", "gan.g_step"]
    by_id = {s.id: s for s in spans}

    def root_of(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    for root in roots:
        inside = [s for s in spans if s is not root and root_of(s) is root]
        assert all(s.request == root.id for s in inside)
        names = [s.name for s in inside]
        for name in ("gan.rollout", "gan.losses", "gan.backward", "optim.step", "cond_encoder"):
            assert names.count(name) == 1, (root.name, name)
        judges = [s for s in inside if s.name == "gan.judge"]
        # real and generated signals, each by the MPD (0) then the MRD (1)
        assert [s.index for s in judges] == [0, 1, 0, 1]
        assert all(by_id[s.parent] is root for s in judges)
        assert names.count("solve.step") == N
    assert len(spans) == len({s.id for s in spans})
    assert drained.counters.get("gan.d_steps") == 1 and drained.counters.get("gan.g_steps") == 1
    assert drained.counters.get("solve.recomputed_steps", 0) == (N if remat else 0)


def test_steps_are_bitwise_the_same_with_the_switch_off_and_on():
    off_losses, off_state = _d_then_g(remat=True)
    tracing.enable()
    on_losses, on_state = _d_then_g(remat=True)
    assert tracing.drain().spans
    assert on_losses == off_losses
    assert all(torch.equal(on_state[k], v) for k, v in off_state.items())
