"""IO: the configparser ``.ini`` surface, recording loaders (HDF5/XDF) and
the headless channel inspection."""
