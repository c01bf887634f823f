"""static-gr — the paper's generative-retrieval serving stack (§5.1).

A PLUM-like dense decoder (~3B params) over Semantic-ID tokens: L=8 SID
levels, token cardinality |V|=2048, beam M=70, dense-mask depth d=2,
constrained to a 20M-item restricted vocabulary.  Same values as
``repro.configs.static_gr``.
"""
import dataclasses

from repro_torch.configs.base import ArchBundle, TransformerConfig


@dataclasses.dataclass(frozen=True)
class GRShape:
    name: str
    kind: str  # "train" | "serve_constrained" | "serve_unconstrained"
    global_batch: int
    beam_size: int = 70
    sid_length: int = 8
    history_len: int = 256  # user-history tokens fed at prefill/train


# ~3B dense params (26L x 3072, GQA 24H/kv8), SID vocab 2048 + BOS/pad.
CONFIG = TransformerConfig(
    name="static-gr-3b",
    n_layers=26,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=2050,
    tie_embeddings=True,
)

SID_VOCAB = 2048
SID_LENGTH = 8
DENSE_D = 2
BEAM_SIZE = 70
HISTORY_LEN = 256  # user-history tokens fed at prefill
N_CONSTRAINTS = 20_000_000  # "fresh video" corpus of §5.2

SHAPES = (
    GRShape("gr_train", "train", global_batch=1024),
    GRShape("gr_serve_constrained", "serve_constrained", global_batch=512),
    GRShape("gr_serve_unconstrained", "serve_unconstrained", global_batch=512),
)

BUNDLE = ArchBundle(
    arch_id="static-gr",
    family="gr",
    config=CONFIG,
    shapes=SHAPES,
    notes=(
        "The paper's exact setting: batch 2/chip x 256 chips = 512 global, "
        "M=70, L=8, |V|=2048, d=2, |C|=20M. Constraint matrix replicated "
        "per chip (paper §A.3)."
    ),
)
