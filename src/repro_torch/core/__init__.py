"""Data diffusion core (the paper's contribution), on PyTorch.

Counterpart of ``repro.core``: the same dispatcher, policies, caches and
index, with the threaded runtime's executor caches holding device tensors.
"""
from .cache import EvictionPolicy, ExecutorCache
from .channel import CallbackChannel, Channel, ChannelClosed, LocalChannel
from .index import IndexUpdate, LocationIndex
from .objects import DataObject, Task, TaskState, make_objects, uniform_tasks
from .policies import Decision, DispatchPolicy, decide
from .runtime import SHAPE_ONLY_PAYLOAD, DiffusionRuntime, ObjectStore
from .scheduler import Dispatcher
from .simulator import SimResult
from .testbeds import ANL_UC, TESTBEDS, TestbedSpec

__all__ = [
    "ANL_UC",
    "CallbackChannel",
    "Channel",
    "ChannelClosed",
    "DataObject",
    "Decision",
    "DiffusionRuntime",
    "DispatchPolicy",
    "Dispatcher",
    "EvictionPolicy",
    "ExecutorCache",
    "IndexUpdate",
    "LocalChannel",
    "LocationIndex",
    "ObjectStore",
    "SHAPE_ONLY_PAYLOAD",
    "SimResult",
    "TESTBEDS",
    "Task",
    "TaskState",
    "TestbedSpec",
    "decide",
    "make_objects",
    "uniform_tasks",
]
