"""The instance-type catalog: capacities, allocatable math, static prices,
offerings, and the market model (the JAX package's ``catalog/``)."""

from .instancetypes import (  # noqa: F401
    InstanceType,
    Offering,
    generate_catalog,
    DEFAULT_ZONES,
    DEFAULT_REGION,
)
from .pricing import MarketModel, PricingProvider  # noqa: F401
from .provider import CatalogProvider, CatalogTensors, OverheadOptions  # noqa: F401
