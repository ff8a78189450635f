"""Typed configuration, bit-compatible with the reference ``config.json``
schema.

The reference threads a raw JSON dict (``settings``) through every stage
(reference: __main__.py:63-67) and rewrites relative input/output paths
against ``output_location`` unless ``FLAGS.ABSPATHS`` (reference:
__main__.py:36-44). The same schema parses into frozen dataclasses here, with
the same rewriting (``os.path.join`` with an absolute right operand is the
identity, so absolute paths survive), and ``to_settings_dict`` for code that
needs the reference-shaped dict.

Schema source of truth: reference config.json:1-76 and README.md:46-71.
This is the port's own copy of ``delivr_cfos_tpu/config.py``: the port
imports nothing of the JAX package, and both parse the same files alike.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

_WORK_PACKAGES = (
    "mask_detection",
    "blob_detection",
    "postprocessing",
    "atlas_alignment",
    "region_assignment",
    "visualization",
)


@dataclass(frozen=True)
class DownsampleSteps:
    """Voxel sizes driving the anisotropic downsample (config.json:9-16)."""

    original_um_x: float = 1.62
    original_um_y: float = 1.62
    original_um_z: float = 6.0
    downsample_um_x: float = 25.0
    downsample_um_y: float = 25.0
    downsample_um_z: float = 25.0

    @property
    def ratios_zyx(self) -> tuple[int, int, int]:
        """Integer downsampling ratios (z, y, x), rounded as the reference does
        (reference: downsample/downsample_and_mask.py:161-163)."""
        return (
            round(self.downsample_um_z / self.original_um_z),
            round(self.downsample_um_y / self.original_um_y),
            round(self.downsample_um_x / self.original_um_x),
        )


@dataclass(frozen=True)
class MaskDetectionConfig:
    ilastik_location: str = ""
    ilastik_model: str = ""
    teraconverter_location: str = ""
    output_location: str = ""
    downsample_steps: DownsampleSteps = field(default_factory=DownsampleSteps)
    mask_with_Ilastik: bool = True
    simple_threshold_value: int = 250
    # framework extension — host ingest parallelism for stage 1 (TIFF
    # decode-ahead of the device downsample; thread-pooled per-plane
    # masking writes). 0 = one worker per host core (capped at 16). The
    # decoders and deflate writers release the GIL, so this scales with the
    # host's cores.
    ingest_threads: int = 0


@dataclass(frozen=True)
class WindowDimensions:
    """UNet sliding-window size (z, y, x) (config.json:24-28)."""

    window_dim_0: int = 96
    window_dim_1: int = 96
    window_dim_2: int = 64

    @property
    def zyx(self) -> tuple[int, int, int]:
        return (self.window_dim_0, self.window_dim_1, self.window_dim_2)


@dataclass(frozen=True)
class BlobDetectionConfig:
    input_location: str = ""
    model_location: str = ""
    output_location: str = ""
    window_dimensions: WindowDimensions = field(default_factory=WindowDimensions)
    # framework extension: shard each volume's sliding-window passes
    # z-spatially across this many devices (parallel/sharded_inference.py).
    # 1 = single device (reference semantics either way); more than there
    # are devices logs a warning and runs on one.
    spatial_shards: int = 1
    # framework extension: distribute independent brains across this many
    # groups of devices, each brain's spatial sharding inside one group
    # (pipeline/runner.py). 1 = no distribution.
    dcn_slices: int = 1
    # framework extension — numerical mode of the UNet forward (the
    # reference exposes its perf controls in config too, config.json:24-28):
    #   'parity' — float32 activations, convolutions without TF32: the
    #              bit-stability configuration;
    #   'fast'   — bf16 activations with f32 conv accumulation and f32
    #              instance-norm statistics, every 3×3×3 conv through the
    #              hand-written conv3d_cs CUDA kernel;
    #   'auto'   — 'fast' on CUDA, 'parity' on the CPU (default).
    precision: str = "auto"
    # framework extension — window blending. 'constant' reproduces the
    # reference quirk (its fork hardcodes a uniform importance map,
    # sliding_window_inferer.py:148); 'gaussian' enables the
    # Gaussian-weighted blending its call site requested (inference.py:212,
    # MONAI compute_importance_map semantics).
    importance: str = "constant"
    # framework extension — binarization re-mask erosion depth. The
    # reference hardcodes 30 iterations (inference/inference.py:84), sized
    # for hemisphere-scale volumes; small test volumes need less or the
    # eroded mask vanishes.
    erosion_iters: int = 30


@dataclass(frozen=True)
class PostprocessingConfig:
    input_location: str = ""
    output_location: str = ""
    min_size: int = -1
    max_size: int = -1
    # framework extension — stage-3 connected-components slab parallelism.
    # 0 = one worker per host core (capped at 8); 1 = serial. The reference's
    # cc3d pass is single-threaded C++ (count_blobs.py:59-64); here each
    # z-slab's native union-find sweep is an independent GIL-releasing call,
    # bit-identical to the serial labeling at any worker count. Values > 1
    # additionally route the in-RAM path through the slab-parallel labeler.
    cc_workers: int = 0


@dataclass(frozen=True)
class AtlasAlignmentConfig:
    input_location: str = ""
    output_location: str = ""
    mBrainAligner_location: str = ""
    collection_folder: str = ""
    parallel_processing: bool = True
    landmarks_hemisphere: bool = False
    # framework extensions (absent from the reference schema; harmless there):
    # landmark marker files for the reference's ``-p a`` hemisphere mode
    # (automate_mBrainaligner.py:40-56): brain-space landmarks and their
    # atlas-space correspondences (Vaa3D .marker or x,y,z CSV). Used when
    # landmarks_hemisphere is true.
    landmarks_file: str = ""
    atlas_landmarks_file: str = ""
    # 50 µm atlas average-template volume (tif/v3draw/npy/nrrd, (z, y, x) =
    # (228, 160, 264)) that the registration aligns against. Empty →
    # geometric-normalization fallback (scale into the atlas box).
    template_file: str = ""
    use_ffd: bool = True
    ffd_spacing: float = 16.0
    # coarse→fine downsample-factor schedule for the FFD stage; (2, 1)
    # front-loads iterations at 8× cheaper gradients on big brains
    ffd_levels: tuple = (1,)
    # intensity similarity for registration: 'ncc' (linear relation) or
    # 'mi' (mutual information — cross-modality-robust)
    similarity: str = "ncc"
    # race axis-flip initializations at the coarse level before the full
    # schedule (recovers mirrored acquisitions, like the reference tool's
    # RANSAC/feature global stage)
    multistart: bool = True
    # stochastic similarity sampling: gradient steps evaluate the
    # similarity on this many fresh jittered-lattice coordinates instead
    # of the full grid (elastix-style random-coordinate sampler). 0 =
    # dense full-grid gradients (default).
    n_samples: int = 0


@dataclass(frozen=True)
class RegionAssignmentConfig:
    input_location: str = ""
    CCF3_atlasfile: str = ""
    CCF3_ontology: str = ""
    output_location: str = ""


@dataclass(frozen=True)
class VisualizationConfig:
    input_csv_location: str = ""
    input_size_location: str = ""
    input_prediction_location: str = ""
    cache_location: str = ""
    output_location: str = ""
    region_id_rgb: bool = True
    region_id_grayvalues: bool = False
    no_atlas_depthmap: bool = False


@dataclass(frozen=True)
class Flags:
    """The reference's 14 FLAGS (config.json:60-75)."""

    ABSPATHS: bool = False
    LOAD_ALL_RAM: bool = True
    TEST_TIME_AUGMENTATION: bool = True
    MASK_DOWNSAMPLE: bool = True
    BLOB_DETECTION: bool = True
    POSTPROCESSING: bool = True
    ATLAS_ALIGNMENT: bool = True
    REGION_ASSIGNMENT: bool = True
    VISUALIZATION: bool = True
    SAVE_MASK_OUTPUT: bool = True
    SAVE_NETWORK_OUTPUT: bool = True
    SAVE_ACTIVATED_OUTPUT: bool = False
    SAVE_POSTPROCESSING_OUTPUT: bool = True
    SAVE_ATLAS_OUTPUT: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    raw_location: str = ""
    output_location: str = ""
    mask_detection: MaskDetectionConfig = field(default_factory=MaskDetectionConfig)
    blob_detection: BlobDetectionConfig = field(default_factory=BlobDetectionConfig)
    postprocessing: PostprocessingConfig = field(default_factory=PostprocessingConfig)
    atlas_alignment: AtlasAlignmentConfig = field(default_factory=AtlasAlignmentConfig)
    region_assignment: RegionAssignmentConfig = field(
        default_factory=RegionAssignmentConfig
    )
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    FLAGS: Flags = field(default_factory=Flags)

    # ---- construction -------------------------------------------------

    @staticmethod
    def from_json(path: str) -> "PipelineConfig":
        with open(path, "r") as f:
            return PipelineConfig.from_dict(json.load(f))

    @staticmethod
    def from_dict(raw: dict[str, Any]) -> "PipelineConfig":
        cfg = PipelineConfig(
            raw_location=raw.get("raw_location", ""),
            output_location=raw.get("output_location", ""),
            mask_detection=_build(
                MaskDetectionConfig,
                raw.get("mask_detection", {}),
                nested={"downsample_steps": DownsampleSteps},
            ),
            blob_detection=_build(
                BlobDetectionConfig,
                raw.get("blob_detection", {}),
                nested={"window_dimensions": WindowDimensions},
            ),
            postprocessing=_build(PostprocessingConfig, raw.get("postprocessing", {})),
            atlas_alignment=_build(AtlasAlignmentConfig, raw.get("atlas_alignment", {})),
            region_assignment=_build(
                RegionAssignmentConfig, raw.get("region_assignment", {})
            ),
            visualization=_build(VisualizationConfig, raw.get("visualization", {})),
            FLAGS=_build(Flags, raw.get("FLAGS", {})),
        )
        return cfg.resolve_paths()

    # ---- path handling -------------------------------------------------

    def resolve_paths(self) -> "PipelineConfig":
        """Rewrite relative input/output/collection paths against
        ``output_location`` unless FLAGS.ABSPATHS (reference: __main__.py:36-44)."""
        if self.FLAGS.ABSPATHS:
            return self
        out = self.output_location
        updated: dict[str, Any] = {}
        for pkg in _WORK_PACKAGES:
            section = getattr(self, pkg)
            changes = {
                f.name: os.path.join(out, getattr(section, f.name))
                for f in dataclasses.fields(section)
                if ("input" in f.name or "output" in f.name or "collection" in f.name)
            }
            updated[pkg] = dataclasses.replace(section, **changes)
        return dataclasses.replace(self, **updated)

    def setup_folders(self) -> None:
        """Create the stage output directory tree (reference: __main__.py:17-34)."""
        os.makedirs(self.output_location, exist_ok=True)
        for pkg in _WORK_PACKAGES:
            section = getattr(self, pkg)
            out = section.output_location
            # the reference creates output_location and its grandparent
            parent = os.path.dirname(os.path.dirname(out.rstrip("/")))
            if parent:
                os.makedirs(parent, exist_ok=True)
            os.makedirs(out, exist_ok=True)
        os.makedirs(self.atlas_alignment.collection_folder, exist_ok=True)

    # ---- reference-shaped dict ------------------------------------------

    def to_settings_dict(self) -> dict[str, Any]:
        """Reference-shaped raw settings dict (post path-resolution)."""
        return dataclasses.asdict(self)


def _build(cls, raw: dict[str, Any], nested: dict[str, type] | None = None):
    """Construct dataclass ``cls`` from a raw dict, ignoring unknown keys."""
    nested = nested or {}
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            continue
        if key in nested and isinstance(val, dict):
            kwargs[key] = _build(nested[key], val)
        else:
            kwargs[key] = val
    return cls(**kwargs)
