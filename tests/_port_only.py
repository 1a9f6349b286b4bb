"""The archs a parity test can hold to the JAX package: the port's
``ARCH_IDS`` less those the JAX package does not have
(``PORT_ONLY_ARCH_IDS``), and a config comparison that reads every JAX
field and holds the port's own fields (YaRN, the split cache) at their
defaults."""
import dataclasses

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro_torch.configs import ARCH_IDS, PORT_ONLY_ARCH_IDS, ArchConfig

#: the port's archs that the JAX package has too, in the port's order
SHARED_ARCH_IDS = tuple(a for a in ARCH_IDS if a in J_ARCH_IDS)


def port_fields(jcfg) -> tuple:
    """The port's ``ArchConfig`` fields that the JAX config lacks."""
    have = {f.name for f in dataclasses.fields(jcfg)}
    return tuple(f for f in dataclasses.fields(ArchConfig)
                 if f.name not in have)


def assert_config_is_jaxs(tcfg, jcfg) -> None:
    """Every JAX field equal, and every port-only field at its default."""
    jd = dataclasses.asdict(jcfg)
    td = dataclasses.asdict(tcfg)
    assert {k: td[k] for k in jd} == jd
    for f in port_fields(jcfg):
        assert getattr(tcfg, f.name) == f.default, f.name
    assert set(td) == set(jd) | {f.name for f in port_fields(jcfg)}


__all__ = ["ARCH_IDS", "J_ARCH_IDS", "PORT_ONLY_ARCH_IDS",
           "SHARED_ARCH_IDS", "assert_config_is_jaxs", "port_fields"]
