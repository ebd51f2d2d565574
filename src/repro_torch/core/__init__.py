"""Port of ``repro.core``: succession, scenarios, the analytical model,
the scalar §5.1 event engine (``availability``), the batched §5.1, §6 and
client-latency engines, the §5.2 micro-simulator (``microsim``, with the
Threefry generator it draws from in ``threefry``), and the protocol
modules (``pac``, ``messages``, ``node``, ``simulator``) and the
linearizability checker copied verbatim for the LARK store.  Import the
submodule you need."""
