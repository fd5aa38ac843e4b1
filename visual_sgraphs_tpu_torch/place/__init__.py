"""Place recognition, loop closing and relocalisation (PyTorch port of
``visual_sgraphs_tpu/place``)."""
