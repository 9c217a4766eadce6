"""Helpers that run the JAX side of the port's tests under ``jax.jit``.

A flax ``init`` or a ``jax.grad`` called outside ``jit`` compiles each
operation on its own (hundreds of small compiles, too quick for the
persistent compilation cache); under ``jit`` the whole function compiles
once. The random draws are the same; a test hands the JAX weights to the
port, so both sides keep computing on one set of weights.
"""
import jax


def jit_energy_force_init(monkeypatch):
    """``gcnn_keras_tpu.model.force.EnergyForceModel.init`` under ``jax.jit``
    for the rest of the test (the JAX drivers call it)."""
    from gcnn_keras_tpu.model.force import EnergyForceModel
    init = EnergyForceModel.init

    def jitted(self, rng, *args, **kwargs):
        return jax.jit(lambda r, *a: init(self, r, *a, **kwargs))(rng, *args)
    monkeypatch.setattr(EnergyForceModel, "init", jitted)


class JitApply:
    """A JAX ``EnergyForceModel`` whose ``apply`` runs under ``jax.jit`` (one
    compile a batch shape and set of keywords), for the JAX package's
    loops that call ``apply`` on it batch by batch."""

    def __init__(self, fmodel):
        self.fmodel, self._jitted = fmodel, {}

    def __getattr__(self, name):
        return getattr(self.fmodel, name)

    def apply(self, variables, batch, **kwargs):
        key = tuple(sorted(kwargs.items()))
        if key not in self._jitted:
            self._jitted[key] = jax.jit(lambda v, b: self.fmodel.apply(v, b, **kwargs))
        return self._jitted[key](variables, batch)
