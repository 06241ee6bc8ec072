"""The JAX reference of the port's parity tests, compiled without XLA's
backend optimizations.

Each parity test runs its JAX functions a few times on small shapes, so
compiling them costs far more than running them.  A test module that
imports `unoptimized_jax_compiles` compiles them with
jax_disable_most_optimizations: the same HLO, lowered without LLVM's
expensive passes (XLA backend optimization level 0).  The flag is set for
the module and restored after it, so the JAX package's own tests in the
same process compile as before."""

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def unoptimized_jax_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)
