"""Port of ``repro.core``: succession, scenarios, the analytical model,
the batched §5.1, §6 and client-latency engines, and the protocol
modules (``pac``, ``messages``, ``node``, ``simulator``) copied verbatim
for the LARK store.  Import the submodule you need."""
