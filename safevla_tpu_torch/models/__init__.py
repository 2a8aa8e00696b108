"""Policy modules of the port: ViT, T5, fusion, decoder, towers (see each module)."""
