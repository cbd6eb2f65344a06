"""IO: the configparser ``.ini`` surface and the offline-mode check."""
