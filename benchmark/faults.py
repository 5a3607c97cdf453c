"""Faults planted under the timed path, to show that the output check
catches each one a cell can have. ``plant(name, config)`` patches the port
in this process for the block, on the module class the configuration
names (its ``module``), so every configuration gets each fault of its kind
(a run over several ranks plants it in every rank). ``of(kind, chips)``
names the faults a cell's kind and chips can have. Used by the tests and by
``calibrate``; the benchmark's own runs plant nothing."""

import contextlib

# The faults a cell can have, by its traffic's kind, and those a cell of
# that kind over several chips can have besides.
BY_KIND = {"serve": ("altered_answer",), "fit": ("unchanged_state", "half_batch")}
ACROSS_CHIPS = {"fit": ("no_exchange",)}


def of(kind, chips):
    """The faults a cell of traffic ``kind`` over ``chips`` chips can have."""
    return BY_KIND[kind] + (ACROSS_CHIPS.get(kind, ()) if chips > 1 else ())


def _altered_answer(cls, modules):
    """A corrected frame altered where it is produced: an 8 x 8 block of the
    module's output inverted."""
    forward = cls.eval_forward

    def eval_forward(self, variables, batch, *args, **kwargs):
        out = forward(self, variables, batch, *args, **kwargs).clone()
        out[:, :8, :8] = 1.0 - out[:, :8, :8]
        return out

    return [(cls, "eval_forward", eval_forward)]


def _unchanged_state(cls, modules):
    """A step that returns its state unchanged: no update is applied."""
    def apply_gradients(self, state):
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1

    return [(cls, "apply_gradients", apply_gradients)]


def _half_batch(cls, modules):
    """Half of the batch left out: each step trains on the first half of its
    rows (their targets drawn as for the whole batch), the loss the mean over
    them."""
    synthesize = cls.synthesize_targets

    def half(self, batch, generator):
        return {k: v[:v.shape[0] // 2] for k, v in synthesize(self, batch, generator).items()}

    return [(cls, "synthesize_targets", half)]


def _no_exchange(cls, modules):
    """The exchange between chips left out: each rank steps on its own
    gradients."""
    return [(modules, "average_gradients", lambda params: None)]


FAULTS = {"altered_answer": _altered_answer, "unchanged_state": _unchanged_state,
          "half_batch": _half_batch, "no_exchange": _no_exchange}


@contextlib.contextmanager
def plant(name, config=None):
    """The fault ``name`` in the port for the block, on the module class
    ``config["module"]``; None plants nothing."""
    if name is None:
        yield
        return
    from color_transfer_tpu_torch.run import modules

    patches = FAULTS[name](getattr(modules, config["module"]), modules)
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in patches]
    for owner, attr, new in patches:
        setattr(owner, attr, new)
    try:
        yield
    finally:
        for owner, attr, old in saved:
            setattr(owner, attr, old)
