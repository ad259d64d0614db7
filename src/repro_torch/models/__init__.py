"""LM substrate of the port (the reference's ``models/``): GQA, MLA, MoE
and the SSD mixer, for every architecture of the registry (phi-3-vision's
patch embeddings included)."""
