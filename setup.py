"""Package build: pip-installable framework + native extension.

The native permutohedral library also builds lazily at first use
(srcaco2_tpu/native/__init__.py); this setup additionally compiles it at
install time (reference analog: create_env.sh's swig build step).
"""
import subprocess
import sys
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        here = Path(__file__).parent
        src = here / 'srcaco2_tpu' / 'native' / 'permutohedral.cpp'
        out = here / 'srcaco2_tpu' / 'native' / 'build' / \
            'libpermutohedral.so'
        out.parent.mkdir(parents=True, exist_ok=True)
        try:
            subprocess.run(['g++', '-O3', '-shared', '-fPIC',
                            '-std=c++17', '-fopenmp', str(src),
                            '-o', str(out)], check=True)
        except Exception as e:  # lazy build remains as fallback
            print(f'[setup] native build deferred: {e}',
                  file=sys.stderr)
        super().run()


setup(
    name='srcaco2-tpu',
    version='0.1.0',
    description='TPU-native super-resolution framework for the '
                'SR-CACO-2 microscopy benchmark',
    packages=find_packages(include=['srcaco2_tpu',
                                    'srcaco2_tpu.*',
                                    'srcaco2_tpu_torch',
                                    'srcaco2_tpu_torch.*']),
    python_requires='>=3.10',
    install_requires=['jax', 'flax', 'optax', 'orbax-checkpoint',
                      'numpy', 'pyyaml'],
    package_data={'srcaco2_tpu.native': ['*.cpp'],
                  'srcaco2_tpu_torch.ops': ['csrc/*.cu', 'csrc/*.cuh']},
    cmdclass={'build_py': BuildWithNative},
)
