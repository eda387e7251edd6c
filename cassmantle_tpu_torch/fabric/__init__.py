"""Room fabric: many rooms over one store, placed across workers.

A copy of ``cassmantle_tpu/fabric/``: :mod:`.directory` (session -> room
-> worker placement on a consistent-hash ring), :mod:`.membership`
(store-backed heartbeats) and :mod:`.rooms` (:class:`RoomFabric`:
per-room ``Game`` engines over namespaced store views, room moves when
membership changes, the graceful handoff). The store one layer down may
be shared by many workers (``native/client.py``) or replicated
(``engine/store.py::ReplicatedStore``).
"""

from cassmantle_tpu_torch.fabric.directory import RoomDirectory
from cassmantle_tpu_torch.fabric.membership import ClusterMembership
from cassmantle_tpu_torch.fabric.rooms import NamespacedStore, RoomFabric

__all__ = [
    "ClusterMembership",
    "NamespacedStore",
    "RoomDirectory",
    "RoomFabric",
]
