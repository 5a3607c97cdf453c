"""Faults planted under the timed path, to show that the output check
catches each one a cell can have. ``plant(name)`` patches the port in this
process for the block (a run over several ranks plants it in every rank).
Used by the tests and by ``calibrate``; the benchmark's own runs plant
nothing."""

import contextlib


def _altered_answer(modules):
    """A corrected frame altered where it is produced: an 8 x 8 block of the
    module's output inverted."""
    forward = modules.DMSCTModule.eval_forward

    def eval_forward(self, variables, batch, *args, **kwargs):
        out = forward(self, variables, batch, *args, **kwargs).clone()
        out[:, :8, :8] = 1.0 - out[:, :8, :8]
        return out

    return [(modules.DMSCTModule, "eval_forward", eval_forward)]


def _unchanged_state(modules):
    """A step that returns its state unchanged: no update is applied."""
    def apply_gradients(self, state):
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1

    return [(cls, "apply_gradients", apply_gradients)
            for cls in (modules.DMSCTModule, modules.DCMCS3DIModule)]


def _half_batch(modules):
    """Half of the batch left out: each step trains on the first half of its
    rows (their targets drawn as for the whole batch), the loss the mean over
    them."""
    synthesize = modules.DMSCTModule.synthesize_targets

    def half(self, batch, generator):
        return {k: v[:v.shape[0] // 2] for k, v in synthesize(self, batch, generator).items()}

    return [(cls, "synthesize_targets", half)
            for cls in (modules.DMSCTModule, modules.DCMCS3DIModule)]


def _no_exchange(modules):
    """The exchange between chips left out: each rank steps on its own
    gradients."""
    return [(modules, "average_gradients", lambda params: None)]


FAULTS = {"altered_answer": _altered_answer, "unchanged_state": _unchanged_state,
          "half_batch": _half_batch, "no_exchange": _no_exchange}


@contextlib.contextmanager
def plant(name):
    """The fault ``name`` in the port for the block; None plants nothing."""
    if name is None:
        yield
        return
    from color_transfer_tpu_torch.run import modules

    patches = FAULTS[name](modules)
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in patches]
    for owner, attr, new in patches:
        setattr(owner, attr, new)
    try:
        yield
    finally:
        for owner, attr, old in saved:
            setattr(owner, attr, old)
