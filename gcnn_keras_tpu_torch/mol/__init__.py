from .io import read_xyz_file, write_xyz_file, read_extxyz_file
from .encoder import OneHotEncoder
