"""The port's config registry against the JAX package's: every arch that
both register, full and smoke, field for field (``dataclasses.asdict``).
The smoke reducer is where a field can silently fall out of the port
(``num_prefix_embeds`` did, before the port's ``ModelConfig`` had it)."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro_torch import configs as tconfigs

SHARED = sorted(set(tconfigs.REGISTRY) & set(jconfigs.REGISTRY))


def test_the_port_registers_every_arch_of_the_jax_package():
    assert SHARED == sorted(jconfigs.REGISTRY)
    assert sorted(tconfigs.REGISTRY) == SHARED


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", SHARED)
def test_config_equals_the_jax_package_field_for_field(arch, variant):
    assert (dataclasses.asdict(tconfigs.get(arch, variant))
            == dataclasses.asdict(jconfigs.get(arch, variant)))


@pytest.mark.parametrize("arch", ["internvl2-1b",
                                  "llama4-maverick-400b-a17b",
                                  "musicgen-medium"])
def test_smoke_keeps_prefix_and_codebooks(arch):
    full, smoke = tconfigs.get(arch), tconfigs.get(arch, "smoke")
    assert smoke.num_prefix_embeds == min(full.num_prefix_embeds, 8)
    assert smoke.num_codebooks == full.num_codebooks
