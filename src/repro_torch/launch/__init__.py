"""Entry points and process groups of the sharded engine
(``torch.distributed``)."""
