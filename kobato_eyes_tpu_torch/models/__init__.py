"""Models: the ViT tagger as torch ``nn.Module``s, pre/postprocess."""
