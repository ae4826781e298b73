"""Data diffusion core (the paper's contribution), on PyTorch.

Counterpart of ``repro.core``: the same dispatcher, policies, caches,
index, provisioner and discrete-event simulator, with the threaded
runtime's executor caches holding device tensors.
"""
from .cache import EvictionPolicy, ExecutorCache
from .channel import CallbackChannel, Channel, ChannelClosed, LocalChannel
from .index import IndexUpdate, LocationIndex, ShardedIndex
from .objects import DataObject, Task, TaskState, make_objects, uniform_tasks
from .policies import Decision, DispatchPolicy, decide
from .provisioner import AllocationPolicy, DynamicResourceProvisioner
from .runtime import SHAPE_ONLY_PAYLOAD, DiffusionRuntime, ObjectStore
from .scheduler import Dispatcher
from .simulator import DiffusionSim, SimConfig, SimNodeRes, SimResult
from .testbeds import ANL_UC, TESTBEDS, TestbedSpec

__all__ = [
    "ANL_UC",
    "AllocationPolicy",
    "CallbackChannel",
    "Channel",
    "ChannelClosed",
    "DataObject",
    "Decision",
    "DiffusionRuntime",
    "DiffusionSim",
    "DispatchPolicy",
    "Dispatcher",
    "DynamicResourceProvisioner",
    "EvictionPolicy",
    "ExecutorCache",
    "IndexUpdate",
    "LocalChannel",
    "LocationIndex",
    "ObjectStore",
    "SHAPE_ONLY_PAYLOAD",
    "ShardedIndex",
    "SimConfig",
    "SimNodeRes",
    "SimResult",
    "TESTBEDS",
    "Task",
    "TaskState",
    "TestbedSpec",
    "decide",
    "make_objects",
    "uniform_tasks",
]
