"""A noise source for the port's ``train`` that replays draws recorded
beforehand as numpy arrays. It imports neither JAX nor the JAX package, so
spawned block-DP ranks unpickle it and replay the JAX package's noise
(``torch_train_helpers.record_jax_noise`` records it in the parent)."""

import torch


class RecordedNoise:
    """``draws[epoch]`` is the epoch's list of draws in call order (one per
    net step, then the embedding update's), each {name: array}."""

    def __init__(self, draws: dict):
        self.draws = draws

    def start_epoch(self, epoch, n_batches):
        self.queue = list(self.draws[epoch])
        if len(self.queue) != n_batches + 1:
            raise ValueError(f"epoch {epoch}: {len(self.queue)} draws recorded for {n_batches} batches")

    def draw(self, latent_shape, q):
        nz = self.queue.pop(0)
        if nz["latent"].shape != tuple(latent_shape):
            raise ValueError(f"recorded latent noise {nz['latent'].shape} != {tuple(latent_shape)}")
        return {k: torch.as_tensor(v) for k, v in nz.items()}
