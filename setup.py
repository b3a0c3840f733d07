from setuptools import find_packages, setup

setup(
    name="confignet-tpu",
    version="0.1.0",
    description="TPU-native framework for controllable neural face image generation (CONFIG)",
    packages=find_packages(include=["confignet_tpu", "confignet_tpu.*",
                                    "confignet_tpu_torch", "confignet_tpu_torch.*"]),
    # the PyTorch port's CUDA kernels are compiled from these at first use
    package_data={"confignet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
    extras_require={
        "full": ["opencv-python", "matplotlib", "scipy", "h5py"],
    },
    entry_points={
        "console_scripts": [
            # the reference's six entry points, installed as commands
            "confignet-train=confignet_tpu.apps.train_confignet:main",
            "confignet-train-latent-gan=confignet_tpu.apps.train_latent_gan:main",
            "confignet-train-attribute-classifier=confignet_tpu.apps.train_attribute_classifier:main",
            "confignet-generate-dataset=confignet_tpu.apps.generate_dataset:main",
            "confignet-demo=confignet_tpu.apps.confignet_demo:main",
            "confignet-eval-controllability=confignet_tpu.apps.evaluate_confignet_controllability:main",
            # the PyTorch port's entry points (they take --device, default cuda)
            "confignet-torch-train=confignet_tpu_torch.apps.train_confignet:main",
            "confignet-torch-train-latent-gan=confignet_tpu_torch.apps.train_latent_gan:main",
            "confignet-torch-train-attribute-classifier="
            "confignet_tpu_torch.apps.train_attribute_classifier:main",
            "confignet-torch-eval-controllability="
            "confignet_tpu_torch.apps.evaluate_confignet_controllability:main",
            "confignet-torch-generate-dataset=confignet_tpu_torch.apps.generate_dataset:main",
            "confignet-torch-demo=confignet_tpu_torch.apps.confignet_demo:main",
        ]
    },
)
