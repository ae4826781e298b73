"""The training input pipeline on the data-diffusion runtime (counterpart
of ``repro.data``)."""
from .dataset import ShardSpec, shard_oid, synthesize
from .pipeline import DiffusionDataPipeline, PipelineConfig

__all__ = ["DiffusionDataPipeline", "PipelineConfig", "ShardSpec",
           "shard_oid", "synthesize"]
