"""IO: the configparser ``.ini`` surface, recording loaders (HDF5/XDF), the
session and decoding-run trial accessors and the headless channel
inspection."""
