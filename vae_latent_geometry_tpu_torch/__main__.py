from vae_latent_geometry_tpu_torch.cli import main

main()
