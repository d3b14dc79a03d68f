from .networks import VAE, Dense, FullyConnectedNetwork, build_vae, parse_layer_sizes

__all__ = ["VAE", "Dense", "FullyConnectedNetwork", "build_vae", "parse_layer_sizes"]
