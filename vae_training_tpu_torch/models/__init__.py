from .conv import ConvVAE, build_conv_vae
from .networks import VAE, Dense, FullyConnectedNetwork, build_vae, parse_layer_sizes

__all__ = ["ConvVAE", "VAE", "Dense", "FullyConnectedNetwork", "build_conv_vae", "build_vae",
           "parse_layer_sizes"]
