"""The app layer of the port: camera automation, the headless CLI, the
quality evaluator and the interactive viewer."""
