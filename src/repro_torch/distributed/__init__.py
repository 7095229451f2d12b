"""The mesh and distributed layer: sharding rules (``sharding``), the
ambient activation mesh (``context``) and the explicit-collective Ising
fleet (``fleet``), on ``torch.distributed``'s ``DeviceMesh`` and
``DTensor``."""

from repro_torch.distributed import sharding  # noqa: F401
