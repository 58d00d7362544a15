"""The six comparison models of Sec. 4 (Fig. 5/6), behind one interface.

Every baseline consumes the same ``Environment.transfer`` API as the paper's
ASM, so the comparison is apples-to-apples: same noise, same setup penalties,
same diurnal load.
"""
from repro_torch.core.baselines.common import BaseTuner, run_transfer
from repro_torch.core.baselines.globus import GlobusStatic
from repro_torch.core.baselines.static import StaticParams
from repro_torch.core.baselines.single_chunk import SingleChunk
from repro_torch.core.baselines.harp import HARP
from repro_torch.core.baselines.ann_ot import ANNOT, annot_params_from_reference
from repro_torch.core.baselines.nelder_mead import NelderMeadTuner

ALL_BASELINES = {
    "GO": GlobusStatic,
    "SP": StaticParams,
    "SC": SingleChunk,
    "HARP": HARP,
    "ANN+OT": ANNOT,
    "NMT": NelderMeadTuner,
}

__all__ = ["BaseTuner", "run_transfer", "GlobusStatic", "StaticParams",
           "SingleChunk", "HARP", "ANNOT", "annot_params_from_reference",
           "NelderMeadTuner", "ALL_BASELINES"]
