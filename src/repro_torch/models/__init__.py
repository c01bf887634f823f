"""Model zoo of the port: transformer LM family (GQA/MLA/sliding window/MoE),
MeshGraphNet, recsys (Wide&Deep / MIND / DLRM / FM), and the RQ-VAE SID
tokenizer."""
from repro_torch.models import gnn, recsys, rqvae, transformer

__all__ = ["gnn", "recsys", "rqvae", "transformer"]
