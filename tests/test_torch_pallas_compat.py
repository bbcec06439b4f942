"""The JAX reference's Pallas kernels under the installed JAX.

The JAX package names its kernels' TPU compiler parameters
``pltpu.TPUCompilerParams``; newer JAX renamed the class to
``pltpu.CompilerParams`` and dropped the old name.  The port's tests hold
its kernels against those Pallas kernels in interpret mode, where the
compiler parameters are ignored, so the old name is bound to the new class
once, when this module is imported.  Every pytest process imports every
test module before it runs any test, so the reference gives the same
answer whichever process runs a test and in whatever order: without the
alias a Pallas reference call succeeds only when the jit cache already
holds the same call traced under another test's alias.
"""

from jax.experimental.pallas import tpu as pltpu

if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams


def test_reference_compiler_params_take_the_reference_arguments():
    """The keyword the JAX package's kernels pass (ops/partition_pallas.py,
    ops/round_pallas.py) is a field of the class the old name resolves to."""
    params = pltpu.TPUCompilerParams(dimension_semantics=("arbitrary",))
    assert tuple(params.dimension_semantics) == ("arbitrary",)
