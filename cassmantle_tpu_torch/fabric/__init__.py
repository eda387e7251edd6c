"""Room fabric: many rooms over one store, placed across workers.

A copy of ``cassmantle_tpu/fabric/``, the path of one worker:
:mod:`.directory` (session -> room -> worker placement),
:mod:`.membership` (store-backed heartbeats) and :mod:`.rooms`
(:class:`RoomFabric`: per-room ``Game`` engines over namespaced store
views). Many workers, a replicated store and peer hedging come in a
later slice.
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
