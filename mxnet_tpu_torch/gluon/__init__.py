"""Gluon of the PyTorch port: so far the model zoo's Llama family
(:mod:`.model_zoo.llama`), as ``torch.nn.Module``s."""
