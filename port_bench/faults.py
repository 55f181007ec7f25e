"""Faults planted underneath the timed path, for the tests that see a
broken run come out not correct and for the readings of a fault at a
cell's own size (`python3 -m port_bench.control --fault <name>`). Each
takes `patch(owner, name, value)`, which sets an attribute for as long as
the caller wants it (pytest's `monkeypatch.setattr`, or `planted`)."""

import contextlib

import numpy as np


def altered_classes(patch):
    from cabinet_tpu_torch.cli import infer

    orig = infer.Segmenter._forward

    def forward(self, x):
        out = orig(self, x)
        q = out.shape[1] // 4
        out[:, :q] = (out[:, :q] + 1) % self.n_classes
        return out

    patch(infer.Segmenter, "_forward", forward)


def half_the_batch_served(patch):
    from cabinet_tpu_torch.cli import infer

    orig = infer.BatchStep.__call__

    def call(self, frames, rows=0):
        half = orig(self, frames[:max(1, len(frames) // 2)], rows)
        return np.concatenate([half, half])[:len(frames)]

    patch(infer.BatchStep, "__call__", call)


def state_unchanged(patch):
    from cabinet_tpu_torch.train import trainer

    def update(state):
        state.step += 1
        state.micro_step = 0
        state.optimizer.sgd.zero_grad(set_to_none=True)

    patch(trainer, "_apply_update", update)


def half_the_batch_trained(patch):
    from cabinet_tpu_torch.cli import train

    orig = train.DeviceAugment.__call__

    def call(self, batch, step, micro_step):
        images, labels = orig(self, batch, step, micro_step)
        b = max(1, images.shape[0] // 2)
        return images[:b], labels[:b]

    patch(train.DeviceAugment, "__call__", call)


def altered_loss(patch):
    from cabinet_tpu_torch.train import trainer

    orig = trainer.ohem_cross_entropy
    patch(trainer, "ohem_cross_entropy",
                        lambda *a, **k: orig(*a, **k) * 1.5)


def altered_probs(patch):
    from cabinet_tpu_torch.eval import evaluator

    orig = evaluator.MscEval._probs

    def probs(self, variables, images):
        p = orig(self, variables, images)
        h = p.shape[1] // 2
        p[:, :h] = p[:, :h].roll(1, dims=-1)
        return p

    patch(evaluator.MscEval, "_probs", probs)


def half_the_batch_scored(patch):
    from cabinet_tpu_torch.eval import evaluator

    orig = evaluator.MscEval._probs

    def probs(self, variables, images):
        p = orig(self, variables, images[:1])
        return p.expand((images.shape[0],) + tuple(p.shape[1:])).clone()

    patch(evaluator.MscEval, "_probs", probs)


FAULTS = {"altered_classes": altered_classes, "half_the_batch_served": half_the_batch_served,
          "state_unchanged": state_unchanged, "half_the_batch_trained": half_the_batch_trained,
          "altered_loss": altered_loss, "altered_probs": altered_probs,
          "half_the_batch_scored": half_the_batch_scored}


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` in place inside the block."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    FAULTS[name](patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
