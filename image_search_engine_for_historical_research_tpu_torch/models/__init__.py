"""Descriptor models: ResNet+SOA backbone, SOLAR retrieval head, extraction.
The local-feature models are the submodules ``models.loftr`` (LoFTR) and
``models.d2net`` (D2-Net)."""

from .extract import (
    DEFAULT_SCALES,
    extract_vectors,
    extract_vectors_single,
    make_extract_fn,
    make_sharded_extract_fn,
    multiscale_descriptor,
)
from .resnet import STAGE_BLOCKS, Bottleneck, FrozenBatchNorm2d, ResNetSOA, SOABlock
from .retrieval import OUTPUT_DIM, RetrievalModel, SolarRetrieval, init_network
from .weights import from_flax_variables, load_torch_checkpoint, to_flax_variables

# the JAX package's names for the same two: its frozen BN module, and its
# SOLAR state_dict -> Flax variables converter
FrozenBatchNorm = FrozenBatchNorm2d
convert_solar_state_dict = to_flax_variables

__all__ = [
    "DEFAULT_SCALES", "extract_vectors", "extract_vectors_single",
    "make_extract_fn", "make_sharded_extract_fn", "multiscale_descriptor",
    "STAGE_BLOCKS", "Bottleneck", "FrozenBatchNorm", "FrozenBatchNorm2d", "ResNetSOA",
    "SOABlock",
    "OUTPUT_DIM", "RetrievalModel", "SolarRetrieval", "init_network",
    "convert_solar_state_dict", "from_flax_variables", "load_torch_checkpoint",
    "to_flax_variables",
]
