"""The app layer of the port: camera automation."""
