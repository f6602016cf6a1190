"""Plain PyTorch counterparts of ``tpufg.ops``: the GLSL-spec oracle."""
