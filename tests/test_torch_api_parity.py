"""Public helpers of the JAX package that the port keeps copies of, held
to the JAX functions on the same arguments: the pre-registry strategy
chooser, the strategy registry's descriptors, the mean ring-hop distance,
the optimizer initialiser of the train-step builder, and the cell specs
and skip rule of the model registry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import api as japi
from repro.core import strategies as jstrat
from repro.launch import train_step as jtrain
from repro.models import config as jconfig
from repro.models import registry as jreg
from repro_torch.configs import ARCHS
from repro_torch.core import api as tapi
from repro_torch.core import strategies as tstrat
from repro_torch.launch import train_step as ttrain
from repro_torch.models import config as tconfig
from repro_torch.models import registry as treg
from repro_torch.optim.adamw import adamw_init


@pytest.mark.parametrize("Hq,Hkv", [(16, 8), (32, 4), (8, 8), (64, 8), (10, 1)])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_choose_strategy_auto_as_in_jax(Hq, Hkv, P):
    assert tapi.choose_strategy("auto", Hq, Hkv, P) == japi.choose_strategy("auto", Hq, Hkv, P)


def test_choose_strategy_names_as_in_jax():
    for name in jstrat.available_strategies():
        assert tapi.choose_strategy(name, 16, 8, 4) == japi.choose_strategy(name, 16, 8, 4)
    with pytest.raises(ValueError, match="unknown SP strategy"):
        tapi.choose_strategy("no_such_strategy", 16, 8, 4)


def test_registered_strategies_as_in_jax():
    got, want = tstrat.registered_strategies(), jstrat.registered_strategies()
    assert [d.name for d in got] == [d.name for d in want] == sorted(d.name for d in want)
    assert all(tstrat.get_strategy(d.name) is d for d in got)
    for g, w in zip(got, want):
        assert (g.requires_window, g.serving_side, g.ring_axes) == (
            w.requires_window, w.serving_side, w.ring_axes)


@pytest.mark.parametrize("P", [0, 1, 2, 3, 4, 5, 8, 16, 17])
def test_mean_ring_hops_as_in_jax(P):
    assert tstrat.mean_ring_hops(P) == jstrat.mean_ring_hops(P)


def test_make_opt_init_initialises_the_step_state():
    assert ttrain.make_opt_init() is adamw_init
    assert callable(jtrain.make_opt_init())
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    state = ttrain.make_opt_init()(params)
    want = jtrain.make_opt_init()({"w": jnp.ones((3, 2)), "b": jnp.zeros(2)})
    assert sorted(state) == sorted(want)
    for moment in ("m", "v"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(state[moment][leaf].numpy(),
                                          np.asarray(want[moment][leaf]))
    assert int(state["step"]) == int(want["step"])


CELLS = [(arch, shape) for arch in sorted(ARCHS) for shape in sorted(tconfig.SHAPES)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_runnable_as_in_jax(arch, shape):
    tcfg, tshape = ARCHS[arch], tconfig.SHAPES[shape]
    jcfg, jshape = JARCHS[arch], jconfig.SHAPES[shape]
    assert treg.runnable(tcfg, tshape) == jreg.runnable(jcfg, jshape)
    kind, specs = treg.input_specs(tcfg, tshape)
    jkind, jspecs = jreg.input_specs(jcfg, jshape)
    assert kind == jkind and sorted(specs) == sorted(jspecs)
    for name, (shp, dtype) in specs.items():
        assert shp == tuple(jspecs[name].shape)
        assert str(dtype).removeprefix("torch.") == str(jspecs[name].dtype)
